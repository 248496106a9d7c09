"""Flash-attention op: dispatch by the device of the tensors, with a
gradient.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  A ``meta`` tensor (a dry run) gets an empty
output, and the kernel's work at its shapes goes to ``kernels._work``.
:class:`FlashAttentionFn` carries the op's gradient: its forward is that
dispatch, and its backward is ``backward.attention_backward`` (PyTorch
operations, the same on every device; the reference has no Pallas
backward).

On DTensors (a model laid out over ranks) the op runs on each rank's
local shards under ``local_map``: the batch split as q's is, the heads
split where q's are and the key heads follow them, anything else
gathered; this is how XLA partitions the reference's ``flash_tile``
scope.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _work
from ...parallel.sharding import as_dtensor, is_dtensor
from . import kernel
from .backward import attention_backward
from .ref import attention_work, check_shapes, flash_attention_ref

__all__ = ["flash_attention_op", "FlashAttentionFn"]


def _forward(q, k, v, window, causal):
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, window=window, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, causal=causal)
    if q.device.type == "meta":
        check_shapes(q, k, v, causal, window)
        B, Sq, H, D = q.shape
        Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
        _work.record("flash_attention", *attention_work(
            B, Sq, Skv, H, Hkv, D, window, Dv, causal))
        return q.new_empty((B, Sq, H, Dv))
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


def _split(q, k, v, window, causal):
    """The op on DTensors: each rank's batch rows (split as q's) and, on
    the mesh dims that split q's heads where the key heads can follow
    (H and Hkv divide, or each rank's query heads read whole key heads),
    its heads; every other split gathered first.  Where q's heads are
    split but the key heads are whole on a rank, the rank takes the key
    heads its query heads read, and their gradients are partial sums over
    that dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    g = H // Hkv
    q_p, kv_p, kv_grad = [], [], []
    head_dims = []
    for i, p in enumerate(q.placements):
        n = dm.size(i)
        if isinstance(p, Shard) and p.dim == 0 and q.shape[0] % n == 0:
            q_p.append(Shard(0))
            kv_p.append(Shard(0))
            kv_grad.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and not head_dims:
            q_p.append(Shard(2))
            if Hkv % n == 0 and (H // n) % g == 0:
                kv_p.append(Shard(2))
                kv_grad.append(Shard(2))
            else:
                head_dims.append((i, n))
                kv_p.append(Replicate())
                kv_grad.append(Partial())
        else:
            q_p.append(Replicate())
            kv_p.append(Replicate())
            kv_grad.append(Replicate())

    def local(ql, kl, vl):
        if head_dims:
            i, n = head_dims[0]
            h_loc = H // n
            first = dm.get_local_rank(i) * h_loc // g
            width = max(1, h_loc // g)
            kl = kl[:, :, first:first + width]
            vl = vl[:, :, first:first + width]
        return FlashAttentionFn.apply(ql.contiguous(), kl.contiguous(),
                                      vl.contiguous(), window, causal)
    return local_map(local, out_placements=q_p,
                     in_placements=(q_p, kv_p, kv_p),
                     in_grad_placements=(q_p, kv_grad, kv_grad),
                     device_mesh=dm, redistribute_inputs=True)(
                         q, as_dtensor(k, dm), as_dtensor(v, dm))


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: Optional[int] = None,
                       causal: bool = True) -> torch.Tensor:
    """GQA attention on the tensors' device: causal, over ``window + 1``
    keys per query when ``window`` is set, or with ``causal=False`` every
    key for every query (an encoder, a cross-attention; no window);
    values may be narrower than queries and keys (MLA).  Differentiable
    in q, k and v.  DTensors run on each rank's shards (:func:`_split`)."""
    if is_dtensor(q):
        return _split(q, k, v, window, causal)
    return FlashAttentionFn.apply(q, k, v, window, causal)
