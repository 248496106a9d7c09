"""Error-feedback int8 gradient compression for the cross-pod axis.

The port of the reference's ``optim/compression.py``.  Each step sends
int8-quantized gradients (4x fewer bytes than float32) and carries the
quantization error forward (error feedback keeps the method unbiased
over time).  ``compress`` / ``decompress`` are pure; ``compressed_psum``
sums over the ``pod`` axis of a ``parallel.sharding.Mesh``: every member
of the axis holds the whole ``x`` (the reference's replicated
``in_specs``), quantizes it, and the int8 copies gathered over the axis
are summed in float32.  The port runs it over one device: an axis whose
members are one device (repeated or not) gathers on it; an axis over
distinct devices is refused, as the port's other splits are (ROADMAP
queue 1 item 16).  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import SPLIT_REFUSAL

__all__ = ["compress", "decompress", "compress_tree", "decompress_tree",
           "compressed_psum"]


def compress(g: torch.Tensor, ef: torch.Tensor):
    """g: float32/bf16 tensor; ef: error-feedback buffer (same shape,
    float32).  Returns (q int8, scale float32 scalar, new_ef)."""
    gf = g.float() + ef
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / \
        torch.tensor(127.0, dtype=torch.float32, device=gf.device)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_ef = gf - q.float() * scale
    return q, scale, new_ef


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: dict, ef_tree: dict):
    """``compress`` over the leaves of nested dicts: (qs, scales, efs),
    each a tree of ``grads``' structure."""
    if isinstance(grads, dict):
        parts = {k: compress_tree(grads[k], ef_tree[k]) for k in grads}
        return tuple({k: v[i] for k, v in parts.items()} for i in range(3))
    return compress(grads, ef_tree)


def decompress_tree(qs: dict, scales: dict, like: dict):
    """``decompress`` over the leaves, each to its ``like`` leaf's
    dtype."""
    if isinstance(qs, dict):
        return {k: decompress_tree(qs[k], scales[k], like[k]) for k in qs}
    return decompress(qs, scales, like.dtype)


def compressed_psum(x: torch.Tensor, ef: torch.Tensor, mesh,
                    axis: str = "pod"):
    """EF-int8 sum over ``mesh``'s ``axis``: each member quantizes its
    (replicated) ``x``, the int8 values and scales are gathered over the
    axis, and ``sum_i scale_i * q_i`` is taken in float32.  Returns
    (total in ``x``'s dtype, new_ef)."""
    devs = tuple(dict.fromkeys(mesh.axis_devices(axis)))
    if len(devs) > 1:
        raise NotImplementedError(
            f"compressed_psum over a {axis!r} axis of {len(devs)} distinct "
            f"devices: {SPLIT_REFUSAL}")
    n = mesh.shape[axis]
    q, s, ne = compress(x, ef)
    qg = q.expand(n, *q.shape)                  # int8 on the wire
    sg = s.expand(n)
    total = torch.tensordot(sg, qg.float(), dims=([0], [0]))
    return total.to(x.dtype), ne
