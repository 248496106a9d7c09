"""Selective-scan op: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernels (``kernel.py``: the scan
forward, and its backward under autograd), a CPU tensor to their plain
PyTorch versions (``ref.py``); there is no fallback from one to the
other.  :class:`SelectiveScanFn` saves the scan's inputs, not its
outputs, so under activation checkpointing it keeps what the block
keeps.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan_op", "SelectiveScanFn"]


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no selective_scan implementation for device "
                         f"{t.device}")
    return t.device.type


class SelectiveScanFn(torch.autograd.Function):
    """``(y, h_T) = scan(u, dt, A, Bc, Cc, h0)`` with its gradient: the
    forward and backward kernels on the card, ``selective_scan_ref`` and
    ``selective_scan_bwd_ref`` on the CPU.  An absent cotangent of
    ``y`` or ``h_T`` counts as zeros."""

    @staticmethod
    def forward(ctx, u, dt, A, Bc, Cc, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, Bc, Cc, h0)
        if _device_kind(u) == "cuda":
            return kernel.selective_scan(u, dt, A, Bc, Cc, h0)
        return selective_scan_ref(u, dt, A, Bc, Cc, h0)

    @staticmethod
    def backward(ctx, dy, dh_T):
        inputs = ctx.saved_tensors
        u = inputs[0]
        dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device) \
            if dy is None else dy.float().contiguous()
        if dh_T is not None:
            dh_T = dh_T.float().contiguous()
        if _device_kind(u) == "cuda":
            grads = kernel.selective_scan_bwd(*inputs, dy, dh_T)
        else:
            grads = selective_scan_bwd_ref(*inputs, dy, dh_T)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, inputs, ctx.needs_input_grad))


def selective_scan_op(u, dt, A, Bc, Cc, h0):
    """The Mamba-1 scan on the tensors' device; returns (y, h_T)."""
    return SelectiveScanFn.apply(u, dt, A, Bc, Cc, h0)
