"""Mamba-1 selective SSM block (falcon-mamba, Hymba's parallel SSM path).

Prefill runs the causal depthwise conv and the projections in PyTorch,
then one ``selective_scan`` over the whole prompt from a zero state: the
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU.  (The reference scans chunks with ``lax.associative_scan``; the
recurrence is the same.)  Decode is the O(1) single-step recurrence in
plain PyTorch.  The cache is ``(conv_state [B,di,K-1], h [B,di,N])``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan_op
from .common import ParamSpec, device_of, fdot, init_scale_out, proj

__all__ = ["ssm_specs", "ssm_prefill", "ssm_decode"]


def ssm_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    return {
        "in_proj": ParamSpec((d, 2, di), axes=("fsdp", None, "tp")),
        "conv_w": ParamSpec((cfg.ssm_conv, di), axes=(None, "tp")),
        "conv_b": ParamSpec((di,), init="zeros", axes=("tp",)),
        "x_proj": ParamSpec((di, dt_rank + 2 * N), axes=("tp", None)),
        "dt_w": ParamSpec((dt_rank, di), scale=dt_rank ** -0.5,
                          axes=(None, "tp")),
        "dt_b": ParamSpec((di,), "float32", "dt_bias", axes=("tp",)),
        "A_log": ParamSpec((di, N), "float32", "mamba_a", axes=("tp", None)),
        "D": ParamSpec((di,), "float32", "ones", axes=("tp",)),
        "out_proj": ParamSpec((di, d), scale=init_scale_out(cfg.n_layers),
                              axes=("tp", "fsdp")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` computes it."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p: dict, x: torch.Tensor):
    """The input projection: u, z [B,S,di] bf16."""
    xz = proj("bsd,dgi->bsgi", x, p["in_proj"])
    return xz[:, :, 0], xz[:, :, 1]


def _post_conv(p: dict, u_conv: torch.Tensor, cfg):
    """u_act (u_conv's dtype), dt [B,S,di] and B, C [B,S,N], all float32
    but u_act."""
    N = cfg.ssm_state
    dt_rank = p["dt_w"].shape[0]
    u_act = F.silu(u_conv.float()).to(u_conv.dtype)
    xp = fdot("bsi,ir->bsr", u_act, p["x_proj"])
    dt_in, Bc, Cc = (xp[..., :dt_rank], xp[..., dt_rank:dt_rank + N],
                     xp[..., dt_rank + N:])
    dt = _softplus(torch.einsum("bsr,ri->bsi", dt_in, p["dt_w"].float())
                   + p["dt_b"])
    return u_act, dt, Bc, Cc


def ssm_prefill(p: dict, x: torch.Tensor, cfg):
    """x: [B,S,d] -> (y [B,S,d], (conv_state, ssm_state))."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    K = cfg.ssm_conv
    u, z = _ssm_inputs(p, x)
    # causal depthwise conv over time, in the input's dtype
    u_pad = F.pad(u, (0, 0, K - 1, 0))
    u_conv = sum(u_pad[:, i:i + S] * p["conv_w"][i] for i in range(K)) \
        + p["conv_b"]
    u_act, dt, Bc, Cc = _post_conv(p, u_conv, cfg)
    A = -torch.exp(p["A_log"])                                  # [di,N]
    h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                     device=device_of(x))
    uf = u_act.float()
    y, h_last = selective_scan_op(uf, dt.contiguous(), A.contiguous(),
                                  Bc.contiguous(), Cc.contiguous(), h0)
    y = y + uf * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = proj("bsi,id->bsd", y, p["out_proj"])
    conv_state = u[:, S - (K - 1):].transpose(1, 2).contiguous()
    return out, (conv_state, h_last)


def ssm_decode(p: dict, x: torch.Tensor, cfg, conv_state, h):
    """x: [B,1,d]; conv_state: [B,di,K-1]; h: [B,di,N].  O(1) step."""
    u, z = _ssm_inputs(p, x)                                    # [B,1,di]
    window = torch.cat([conv_state, u[:, 0, :, None]], dim=2)   # [B,di,K]
    u_conv = (window * p["conv_w"].T).sum(-1) + p["conv_b"]
    u_act, dt, Bc, Cc = _post_conv(p, u_conv[:, None], cfg)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt[:, 0, :, None] * A)                       # [B,di,N]
    db = (dt[:, 0] * u_act[:, 0].float())[..., None] * Bc[:, 0, None]
    h_new = da * h + db
    y = torch.einsum("bin,bn->bi", h_new, Cc[:, 0])
    y = y + u_act[:, 0].float() * p["D"]
    y = (y * F.silu(z[:, 0].float()))[:, None].to(x.dtype)
    out = proj("bsi,id->bsd", y, p["out_proj"])
    return out, (window[:, :, 1:].contiguous(), h_new)
