"""Flash-attention op: dispatch by the device of the tensors, with a
gradient.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  :class:`FlashAttentionFn` carries the op's
gradient: its forward is that dispatch, and its backward is
``backward.attention_backward`` (PyTorch operations, the same on both
devices; the reference has no Pallas backward).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .backward import attention_backward
from .ref import flash_attention_ref

__all__ = ["flash_attention_op", "FlashAttentionFn"]


def _forward(q, k, v, window, causal):
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, window=window, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, causal=causal)
    raise ValueError(f"no flash_attention implementation for device "
                     f"{q.device}")


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention_op`` under autograd: saves q, k, v and the
    output; the backward recomputes the scores a block of queries at a
    time (``backward.attention_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        o = _forward(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.window, ctx.causal = window, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, do, ctx.window,
                                        ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: Optional[int] = None,
                       causal: bool = True) -> torch.Tensor:
    """GQA attention on the tensors' device: causal, over ``window + 1``
    keys per query when ``window`` is set, or with ``causal=False`` every
    key for every query (an encoder, a cross-attention; no window);
    values may be narrower than queries and keys (MLA).  Differentiable
    in q, k and v."""
    return FlashAttentionFn.apply(q, k, v, window, causal)
