"""Attention: GQA with RoPE, for prefill and for one-token decode.

Prefill runs causal attention, full or over a sliding window, through
``kernels.flash_attention.flash_attention_op`` (called by the model): the
hand-written CUDA kernel on the card, its plain PyTorch version on the
CPU.  Decode (one new token against the
cache) is one fused pass in plain PyTorch, as in the reference.  Layouts
are the reference's: ``[B, S, H, D]`` for queries, keys and values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import NEG
from .common import (ParamSpec, apply_rope, fdot, init_scale_out, proj,
                     rmsnorm, rope_freqs)

__all__ = ["gqa_specs", "gqa_qkv", "gqa_out", "decode_attention"]


def gqa_specs(cfg) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the reference's tensor-parallel axis: over the heads, or over the head
    # dim where the heads do not divide (tp_heads=False, Hymba)
    h_ax, d_ax = ("tp", None) if cfg.tp_heads else (None, "tp")
    out = {
        "wq": ParamSpec((d, H, hd), axes=("fsdp", h_ax, d_ax)),
        "wk": ParamSpec((d, Hkv, hd), axes=("fsdp", h_ax, d_ax)),
        "wv": ParamSpec((d, Hkv, hd), axes=("fsdp", h_ax, d_ax)),
        "wo": ParamSpec((H, hd, d), scale=init_scale_out(cfg.total_layers),
                        axes=(h_ax, d_ax, "fsdp")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((hd,), "float32", "ones", axes=(None,))
        out["k_norm"] = ParamSpec((hd,), "float32", "ones", axes=(None,))
    return out


def gqa_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Project and rotate; returns contiguous bf16 q [B,S,H,D] and k, v
    [B,S,Hkv,D]."""
    q = proj("bsd,dhk->bshk", x, p["wq"])
    k = proj("bsd,dhk->bshk", x, p["wk"])
    v = proj("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        cos, sin = cos[:, :, None], sin[:, :, None]    # [B,S,1,hd/2]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    return proj("bshk,hkd->bsd", o, p["wo"])


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     window: Optional[int] = None):
    """q: [B,1,H,D]; caches: [B,S,Hkv,D] (a ring when ``window`` is set).

    The reference's validity rule: slots past ``pos`` are masked, and with
    a window the whole ring counts as valid once ``pos >= S``.  Softmax
    in float32, ``p`` rounded to the values' dtype before ``p·v``.
    """
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    kr = k_cache.repeat_interleave(g, dim=2)
    vr = v_cache.repeat_interleave(g, dim=2)
    s = fdot("bqhd,bkhd->bhk", q, kr) * (1.0 / math.sqrt(D))
    idx = torch.arange(S, device=q.device)
    valid = idx <= pos
    if window is not None and pos >= S:
        valid = torch.ones_like(valid)
    s = torch.where(valid[None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = fdot("bhk,bkhd->bhd", p.to(vr.dtype), vr)
    return out[:, None].to(q.dtype)
