"""Selective-scan op: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernels (``kernel.py``: the scan
forward, and its backward under autograd), a CPU tensor to their plain
PyTorch versions (``ref.py``); there is no fallback from one to the
other.  A ``meta`` tensor (a dry run) gets empty outputs, and each
kernel's work at its shapes goes to ``kernels._work``.
:class:`SelectiveScanFn` saves the scan's inputs, not its outputs, so
under activation checkpointing it keeps what the block keeps.

On DTensors (a model laid out over ranks) the op runs on each rank's
local shards under ``local_map``: batch rows split as u's are, channels
split where u's are (A, h0 and the state with them), B and C whole
along the channels; this is how XLA partitions the reference's
``ssm_chunk`` scope.
"""
from __future__ import annotations

import torch

from .. import _work
from ...parallel.sharding import as_dtensor, is_dtensor
from . import kernel
from .ref import (check_shapes, scan_bwd_work, scan_work,
                  selective_scan_bwd_ref, selective_scan_ref)

__all__ = ["selective_scan_op", "SelectiveScanFn"]


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
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
        kind = _device_kind(u)
        if kind == "cuda":
            return kernel.selective_scan(u, dt, A, Bc, Cc, h0)
        if kind == "meta":
            check_shapes(u, dt, A, Bc, Cc, h0)
            w = scan_work(*u.shape, A.shape[-1])
            _work.record("selective_scan", w["flops"], w["bytes"])
            return (u.new_empty(u.shape, dtype=torch.float32),
                    h0.new_empty(h0.shape, dtype=torch.float32))
        return selective_scan_ref(u, dt, A, Bc, Cc, h0)

    @staticmethod
    def backward(ctx, dy, dh_T):
        inputs = ctx.saved_tensors
        u = inputs[0]
        dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device) \
            if dy is None else dy.float().contiguous()
        if dh_T is not None:
            dh_T = dh_T.float().contiguous()
        kind = _device_kind(u)
        if kind == "cuda":
            grads = kernel.selective_scan_bwd(*inputs, dy, dh_T)
        elif kind == "meta":
            w = scan_bwd_work(*u.shape, inputs[2].shape[-1])
            _work.record("selective_scan_bwd", w["flops"], w["bytes"])
            grads = tuple(x.new_empty(x.shape, dtype=torch.float32)
                          for x in inputs)
        else:
            grads = selective_scan_bwd_ref(*inputs, dy, dh_T)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, inputs, ctx.needs_input_grad))


def _split(u, dt, A, Bc, Cc, h0):
    """The op on DTensors: each rank's batch rows and channels, split
    as u's are (A and h0 with them; B and C whole along the channels,
    so their gradients are partial sums over a channel split, and A's
    over a batch split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = u.device_mesh
    rows, chans = [], []
    for i, p in enumerate(u.placements):
        rows.append(isinstance(p, Shard) and p.dim == 0)
        chans.append(isinstance(p, Shard) and p.dim == 2)

    def pl(row=None, chan=None, row_grad=False, chan_grad=False):
        out = []
        for r, c in zip(rows, chans):
            if r:
                out.append(Shard(row) if row is not None else
                           Partial() if row_grad else Replicate())
            elif c:
                out.append(Shard(chan) if chan is not None else
                           Partial() if chan_grad else Replicate())
            else:
                out.append(Replicate())
        return out
    u_p, a_p, bc_p, h_p = pl(0, 2), pl(None, 0), pl(0, None), pl(0, 1)
    return local_map(
        lambda *xs: SelectiveScanFn.apply(*(x.contiguous() for x in xs)),
        out_placements=(u_p, h_p),
        in_placements=(u_p, u_p, a_p, bc_p, bc_p, h_p),
        in_grad_placements=(u_p, u_p, pl(None, 0, row_grad=True),
                            pl(0, None, chan_grad=True),
                            pl(0, None, chan_grad=True), h_p),
        device_mesh=dm, redistribute_inputs=True)(
            *(as_dtensor(x, dm) for x in (u, dt, A, Bc, Cc, h0)))


def selective_scan_op(u, dt, A, Bc, Cc, h0):
    """The Mamba-1 scan on the tensors' device; returns (y, h_T).
    DTensors run on each rank's shards (:func:`_split`)."""
    if is_dtensor(u):
        return _split(u, dt, A, Bc, Cc, h0)
    return SelectiveScanFn.apply(u, dt, A, Bc, Cc, h0)
