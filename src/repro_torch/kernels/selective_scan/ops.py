"""Selective-scan op: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.
"""
from __future__ import annotations

from . import kernel
from .ref import selective_scan_ref

__all__ = ["selective_scan_op"]


def selective_scan_op(u, dt, A, Bc, Cc, h0):
    """The Mamba-1 scan on the tensors' device; returns (y, h_T)."""
    if u.device.type == "cuda":
        return kernel.selective_scan(u, dt, A, Bc, Cc, h0)
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, A, Bc, Cc, h0)
    raise ValueError(f"no selective_scan implementation for device "
                     f"{u.device}")
