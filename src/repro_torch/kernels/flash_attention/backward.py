"""The gradient of flash attention, in PyTorch operations.

The reference has no Pallas backward: JAX differentiates its jnp
``attention_core``, which checkpoints each block of queries
(``repro/models/attention.py:120-124``) so that the backward recomputes
a block's scores instead of keeping the float32 softmax of every
(query, key) pair.  :func:`attention_backward` is that backward written
out, over the same blocks: for each block of ``Q_BLOCK`` queries it
recomputes ``s = q·kᵀ·scale`` in float32 under the forward's mask
(causal with queries at the end of the keys, over ``window + 1`` keys
with a window, or not causal) over the keys that block can see, takes
``p = softmax(s)``, and accumulates

    dv += pᵀ·do,   dp = do·vᵀ,   ds = p ∘ (dp − rowsum(do ∘ o)),
    dq  = ds·k·scale,   dk += dsᵀ·q·scale,

every product a float32 ``torch.matmul`` of the bf16 values (exact
products, float32 sums).  The query heads of a key head are laid out as
rows of one product, so ``dk`` and ``dv`` come out summed over each key
head's group.  The same code runs on the card and on the CPU.  It is not
a port of a TPU kernel (the reference has none); the hand-written
forward kernel's output ``o`` enters only through ``rowsum(do ∘ o)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .ref import NEG, check_shapes

__all__ = ["Q_BLOCK", "key_range", "attention_backward"]

Q_BLOCK = 512           # queries a block (the reference's q_block)


def key_range(q0: int, q1: int, sq: int, skv: int,
              window: Optional[int] = None, causal: bool = True) -> tuple:
    """The keys ``[lo, hi)`` that queries ``q0 .. q1 - 1`` may see: all
    of them when not causal; causal, up to the last query's position
    (queries sit at ``i + skv - sq``) and, with a window, from ``window``
    before the first query's."""
    if not causal:
        return 0, skv
    off = skv - sq
    hi = min(q1 + off, skv)
    lo = max(q0 + off - window, 0) if window is not None else 0
    return lo, hi


def attention_backward(q, k, v, o, do, window: Optional[int] = None,
                       causal: bool = True, q_block: int = Q_BLOCK):
    """q [B,Sq,H,Dqk], k [B,Skv,Hkv,Dqk], v [B,Skv,Hkv,Dv], the forward's
    output o and its gradient do [B,Sq,H,Dv] -> (dq, dk, dv) in the
    dtypes of q, k and v."""
    check_shapes(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    def heads(t, width):            # [B,S,H,w] -> [B,Hkv,g,S,w] float32
        return t.reshape(B, -1, Hkv, g, width).permute(0, 2, 3, 1, 4) \
            .float()
    qf, dof, of = heads(q, D), heads(do, Dv), heads(o, Dv)
    kf = k.permute(0, 2, 1, 3).float()                      # [B,Hkv,Skv,D]
    vf = v.permute(0, 2, 1, 3).float()
    # rowsum(do ∘ o): [B,Hkv,g,Sq]
    delta = (dof * of).sum(-1)
    dq = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, Dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, q_block):
        q1 = min(q0 + q_block, Sq)
        lo, hi = key_range(q0, q1, Sq, Skv, window, causal)
        n = q1 - q0
        qb = qf[:, :, :, q0:q1].reshape(B, Hkv, g * n, D)
        dob = dof[:, :, :, q0:q1].reshape(B, Hkv, g * n, Dv)
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=dev)[:, None] + (Skv - Sq)
            kpos = torch.arange(lo, hi, device=dev)[None, :]
            live = kpos <= qpos
            if window is not None:
                live &= kpos > qpos - (window + 1)
            s = s.view(B, Hkv, g, n, hi - lo).masked_fill(~live, NEG) \
                .view(B, Hkv, g * n, hi - lo)
        p = torch.softmax(s, dim=-1)
        dv[:, :, lo:hi] += torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        ds = p * (dp - delta[:, :, :, q0:q1].reshape(B, Hkv, g * n, 1))
        dq[:, :, :, q0:q1] = (torch.matmul(ds, kb) * scale).view(
            B, Hkv, g, n, D)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(-1, -2), qb) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
