"""Flash-attention op: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import flash_attention_ref

__all__ = ["flash_attention_op"]


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: Optional[int] = None,
                       causal: bool = True) -> torch.Tensor:
    """GQA attention on the tensors' device: causal, over ``window + 1``
    keys per query when ``window`` is set, or with ``causal=False`` every
    key for every query (an encoder, a cross-attention; no window);
    values may be narrower than queries and keys (MLA)."""
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, window=window, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, causal=causal)
    raise ValueError(f"no flash_attention implementation for device "
                     f"{q.device}")
