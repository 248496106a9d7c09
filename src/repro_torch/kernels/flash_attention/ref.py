"""Plain PyTorch version of the flash-attention forward kernel.

``flash_attention_ref`` computes what the hand-written kernel in
``csrc/flash_attention.cu`` computes, in the kernel's order: keys in tiles
of ``BLOCK_K`` = 64, ``s = (q·kᵀ) * scale`` in float32 (bf16 products are
exact), a running max ``m`` and sum ``l`` in float32, ``p = exp(s - m)``
rounded to the values' dtype before ``p·v``, and ``acc / max(l, 1e-30)``
at the end.  Values may be narrower than queries and keys (MLA's: 192
and 128), as in the reference's ``attention_core``; the scale is
``1 / sqrt(Dqk)``.  This is the reference's Pallas kernel
(``repro/kernels/flash_attention/kernel.py``) with a sliding window
added.  Causal, the mask keeps ``kpos <= qpos`` and, with a window,
``kpos > qpos - (window + 1)``, so a query sees ``window + 1`` keys (the
reference's ``attention_core`` and ``attention_ref``); queries sit at the
end of the keys: query ``i`` is at position ``i + Skv - Sq``, so
``Sq <= Skv``.  Not causal (``causal=False``: an encoder's
self-attention, a cross-attention over a context), every query sees
every key, ``Sq`` and ``Skv`` are free, and there is no window (no model
calls that pair, and the Pallas kernel has none).

The kernel skips key tiles that are masked for a whole tile of queries;
this version does not, and gets the same numbers: a masked entry adds
``exp(NEG - m) = 0`` once a row has met a live key, and the ``1``\\ s that
``exp(NEG - NEG)`` leaves in a row that has not are cleared by the next
tile's ``alpha = exp(NEG - m) = 0``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG", "BLOCK_K", "MAX_DIFF_SHARE", "check_shapes",
           "flash_attention_ref", "live_pairs", "attention_work",
           "max_weight", "compare_bf16"]

NEG = -1e30
BLOCK_K = 64        # keys per tile (the CUDA kernel's)
# share of bf16 outputs that may differ at all between the kernel and this
# version: rare one-ulp flips (about 0.03 % measured on an H100 at
# Hymba's prefill shapes, chip_smoke.py phase 9), while a key dropped from
# or added to every row flips most outputs
MAX_DIFF_SHARE = 1e-3


def check_shapes(q, k, v, causal: bool = True,
                 window: Optional[int] = None) -> None:
    """Raise on shapes the kernel and this version do not take: q
    [B,Sq,H,Dqk], k [B,Skv,Hkv,Dqk] and v [B,Skv,Hkv,Dv], ``Sq <= Skv``
    when causal, and no window when not."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q [B,Sq,H,Dqk], k [B,Skv,Hkv,Dqk] and "
                         f"v [B,Skv,Hkv,Dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (H must be a multiple of Hkv)")
    if causal and Sq > k.shape[1]:
        raise ValueError(f"causal attention needs Sq <= Skv (every query "
                         f"has a key), got Sq={Sq}, Skv={k.shape[1]}")
    if not causal and window is not None:
        raise ValueError(f"non-causal attention takes no window, got "
                         f"window={window}")
    if not causal and k.shape[1] == 0 and Sq:
        raise ValueError("non-causal attention needs a key (Skv >= 1)")


def _mask(sq: int, skv: int, window: Optional[int], device,
          causal: bool = True) -> torch.Tensor:
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - (window + 1)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None,
                        causal: bool = True) -> torch.Tensor:
    """Causal (or, with ``causal=False``, full) attention.  q:
    [B,Sq,H,Dqk]; k: [B,Skv,Hkv,Dqk]; v: [B,Skv,Hkv,Dv]; returns
    [B,Sq,H,Dv] in q's dtype.  Query head ``h`` reads key head
    ``h // (H // Hkv)``."""
    check_shapes(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.float().transpose(1, 2)                              # [B,H,Sq,D]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)  # [B,H,Skv,D]
    vr = v.transpose(1, 2).repeat_interleave(g, dim=1)
    live = _mask(Sq, Skv, window, dev, causal)
    m = torch.full((B, H, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=dev)
    for k0 in range(0, Skv, BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + BLOCK_K], vr[:, :, k0:k0 + BLOCK_K]
        s = (qf @ kb.transpose(-1, -2)) * scale                 # [B,H,Sq,bk]
        s = torch.where(live[:, k0:k0 + BLOCK_K], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vb.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def live_pairs(sq: int, skv: int, window: Optional[int] = None,
               causal: bool = True) -> int:
    """(query, key) pairs the mask keeps, per batch row and head: every
    ``sq * skv`` of them when not causal, else query ``i``, at position
    ``p = i + skv - sq``, sees ``min(p + 1, window + 1)`` keys and none
    where ``p < 0``.  In closed form, in Python integers: no tensor
    operation, so a dry run's accountant does not see it."""
    if not causal:
        return sq * skv

    def ramp(a: int, b: int) -> int:          # sum of p + 1 for p in [a, b]
        return 0 if b < a else (b + 1) * (b + 2) // 2 - a * (a + 1) // 2
    a, b = max(skv - sq, 0), skv - 1
    if window is None:
        return ramp(a, b)
    return ramp(a, min(b, window)) + (window + 1) * max(
        0, b - max(a, window + 1) + 1)


def attention_work(b: int, sq: int, skv: int, h: int, hkv: int, d: int,
                   window: Optional[int] = None, dv: Optional[int] = None,
                   causal: bool = True) -> tuple:
    """(operations, bytes) of one launch of the forward kernel: 2 (d +
    dv) operations per live (query, key) pair and head (``q·k`` and
    ``p·v``), and bf16 q, k, v read once and o written once."""
    dv = d if dv is None else dv
    n_bytes = 2 * (b * sq * h * (d + dv) + b * skv * hkv * (d + dv))
    ops = 2 * (d + dv) * b * h * live_pairs(sq, skv, window, causal)
    return ops, n_bytes


def max_weight(q: torch.Tensor, k: torch.Tensor,
               window: Optional[int] = None,
               causal: bool = True) -> torch.Tensor:
    """The largest softmax weight of each query row, ``[B,Sq,H]`` float32:
    ``1 / sum exp(s - max s)`` over the row's live keys.  One batch row and
    one key head at a time, so the scores take ``[H/Hkv, Sq, Skv]``."""
    check_shapes(q, k, k, causal, window)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    live = _mask(Sq, Skv, window, q.device, causal)
    out = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        for j in range(Hkv):
            qs = q[b, :, j * g:(j + 1) * g].float().transpose(0, 1)
            s = (qs @ k[b, :, j].float().T) * (1.0 / math.sqrt(D))
            s = s.masked_fill(~live, -math.inf)
            out[b, j * g:(j + 1) * g] = torch.exp(
                s.amax(-1) - torch.logsumexp(s, -1))
    return out.transpose(1, 2)


def compare_bf16(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int] = None, causal: bool = True) -> dict:
    """Hold a bf16 kernel output ``got`` to this version's ``want`` on the
    same inputs, element by element.

    The two sum in float32 in other orders, which moves two things:
    the output's own bf16 rounding (one ulp, at most ``2^-7 |want|``) and,
    rarely, the bf16 rounding of one ``p`` before ``p·v``, which moves the
    row's outputs by one ulp of that ``p`` times its value, at most
    ``2^-7 * max_weight(row) * max|v|``.  Each element is held to the sum
    of the two, and at most ``MAX_DIFF_SHARE`` of the outputs (and never
    fewer than two query rows' worth, ``2 Dv``) may differ at all.
    Returns ``max_abs_err``, ``worst`` (the largest error over its
    element's bound), ``n_diff``, ``n_allowed`` and ``ok``."""
    w = max_weight(q, k, window, causal)[..., None]
    want_f, got_f = want.float(), got.float()
    err = (got_f - want_f).abs()
    bound = 2 ** -7 * (want_f.abs() + w * float(v.float().abs().max()))
    ratio = torch.where(err > 0, err / bound, torch.zeros_like(err))
    worst = float(ratio.max()) if err.numel() else 0.0
    n_diff = int((got != want).sum())
    n_allowed = max(int(MAX_DIFF_SHARE * got.numel()), 2 * got.shape[-1])
    return dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
                worst=worst, n_diff=n_diff, n_allowed=n_allowed,
                ok=worst <= 1.0 and n_diff <= n_allowed)
