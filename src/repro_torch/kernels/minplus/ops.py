"""Min-plus ops: dispatch by the device of the tensors, and all-pairs hop
distances by min-plus powering.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  Both give the same bits.
"""
from __future__ import annotations

import torch

from ..._device import resolve_device
from . import kernel
from .ref import INF, adjacency_matrix, minplus_powers, minplus_ref

__all__ = ["INF", "minplus_op", "all_pairs_distances"]


def minplus_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (min, +) ``b`` on the tensors' device, capped at ``INF``."""
    if a.device.type == "cuda":
        return kernel.minplus(a, b)
    if a.device.type == "cpu":
        return minplus_ref(a, b)
    raise ValueError(f"no minplus implementation for device {a.device}")


def all_pairs_distances(nbrs, n_iters=None, *, device=None) -> torch.Tensor:
    """Hop distances between all switch pairs by repeated squaring.

    ``nbrs``: padded neighbour array [N, P] (as in ``core.Topology``).
    ``n_iters``: number of squarings (default 5: diameters up to 32).
    Returns float32 [N, N] on ``device`` (``INF`` = unreachable);
    ``device=None`` means the card.
    """
    adj = adjacency_matrix(nbrs, device=resolve_device(device))
    return minplus_powers(adj, minplus_op,
                          n_iters=5 if n_iters is None else n_iters)[0]
