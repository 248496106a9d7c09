"""Min-plus ops: dispatch by the device of the tensors, and all-pairs hop
distances by min-plus powering.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  Both give the same bits.  ``minplus_op`` is the
float32 product, ``minplus_hops_op`` the int16 hop-count product that
the table build runs (``repro_torch.core.routing.hop_distances``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..._device import resolve_device
from . import kernel
from .ref import (INF, adjacency_matrix, minplus_hops_ref, minplus_powers,
                  minplus_ref)

__all__ = ["INF", "minplus_op", "minplus_hops_op", "all_pairs_distances"]


def minplus_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (min, +) ``b`` on the tensors' device, capped at ``INF``."""
    if a.device.type == "cuda":
        return kernel.minplus(a, b)
    if a.device.type == "cpu":
        return minplus_ref(a, b)
    raise ValueError(f"no minplus implementation for device {a.device}")


def minplus_hops_op(at: torch.Tensor, b: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int16 ``at`` [K, M] (A given k-major) (min, +) ``b`` [K, N] on the
    tensors' device, capped at ``HOPS_INF``; written into ``out`` [M, N]
    when given (on the card in the layout of ``ref.padded_hops``)."""
    if at.device.type == "cuda":
        return kernel.minplus_hops(at, b, out)
    if at.device.type == "cpu":
        c = minplus_hops_ref(at, b)
        return c if out is None else out.copy_(c)
    raise ValueError(f"no minplus_hops implementation for device "
                     f"{at.device}")


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
