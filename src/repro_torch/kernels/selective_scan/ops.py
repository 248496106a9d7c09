"""Selective-scan op: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  On the CPU the plain version is differentiable
(autograd through its steps), so the hybrid and mamba blocks train
there.  The kernel has no backward yet: on the card, a call that needs
a gradient raises (ROADMAP queue 1 item 17).
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import selective_scan_ref

__all__ = ["selective_scan_op", "NO_CARD_BACKWARD"]

NO_CARD_BACKWARD = ("selective_scan has no backward on the card yet "
                    "(ROADMAP queue 1 item 17): the hybrid and mamba "
                    "blocks train on the CPU only")


def selective_scan_op(u, dt, A, Bc, Cc, h0):
    """The Mamba-1 scan on the tensors' device; returns (y, h_T)."""
    if u.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (u, dt, A, Bc, Cc, h0)):
            raise RuntimeError(NO_CARD_BACKWARD)
        return kernel.selective_scan(u, dt, A, Bc, Cc, h0)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, A, Bc, Cc, h0)
    raise ValueError(f"no selective_scan implementation for device "
                     f"{u.device}")
