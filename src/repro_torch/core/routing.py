"""Routing tables for randomly-wired indirect networks (Section 4.3).

The port's own copy of the reference's table build: hop distances from
every leaf, as int16 rows equal to the reference's ``dist_leaf``.  The
device picks how they are computed.  On the host (no device, or the
CPU) they come from a BFS over blocks of sources; on the card from
min-plus powering of the adjacency matrix through the CUDA ``minplus``
kernel (``repro_torch.kernels.minplus``), which gives the same table and
leaves it on the card.  The simulator packs its port-mask words from
these rows on its own device (``simulator.engine.pack_mask_block``);
:func:`_pack_mask_block` is the reference's numpy packing, kept as the
host version that the device words are checked against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.minplus.ops import INF, minplus_op
from ..kernels.minplus.ref import adjacency_matrix, minplus_powers
from .topology import Topology

__all__ = [
    "bfs_distances",
    "minplus_distances",
    "RoutingTables",
    "build_tables",
]


def bfs_distances(topo: Topology, sources: np.ndarray) -> np.ndarray:
    """[len(sources), N] int16 hop distances (-1 = unreachable).

    Level-synchronous BFS over blocks of sources: each hop level expands
    every block member's frontier in one scatter, so the work follows the
    frontier population rather than ``B * N * P``.
    """
    nbrs = topo.nbrs
    n, p = topo.n_switches, nbrs.shape[1]
    sources = np.asarray(sources, dtype=np.int64)
    k = len(sources)
    out = np.full((k, n), -1, np.int16)
    block = 256
    for lo in range(0, k, block):
        hi = min(lo + block, k)
        b = hi - lo
        frontier = np.zeros((b, n), bool)
        frontier[np.arange(b), sources[lo:hi]] = True
        visited = frontier.copy()
        dist = out[lo:hi]
        d = 0
        while True:
            rows, nodes = np.nonzero(frontier)
            if rows.size == 0:
                break
            dist[rows, nodes] = d
            cand = nbrs[nodes]                       # [F, P]
            ok = (cand >= 0).ravel()
            nxt = np.zeros_like(frontier)
            nxt[np.repeat(rows, p)[ok], cand.ravel()[ok]] = True
            frontier = nxt & ~visited
            visited |= frontier
            d += 1
    return out


def minplus_distances(topo: Topology, device, max_pow: int = 16):
    """``([N, N] float32 hop distances on device, squarings)``.

    Squares the adjacency matrix under (min, +) until a squaring changes
    nothing (``kernels.minplus.minplus_powers``); ``INF`` marks an
    unreachable pair.  Testing the fixpoint costs one host sync per
    squaring, at set-up time only.
    """
    return minplus_powers(adjacency_matrix(topo.nbrs, device=device),
                          minplus_op, max_pow=max_pow)


def _hops_int16(d: torch.Tensor) -> torch.Tensor:
    """float32 min-plus distances -> the BFS's int16 table (-1 where
    unreachable), on the device of ``d``."""
    return torch.where(d >= INF, -1.0, d).to(torch.int16)


@dataclasses.dataclass
class RoutingTables:
    """Precomputed routing state for the simulator.

    ``dist_leaf`` is an int16 tensor ``[N1, N]`` of hop distances from
    each leaf (-1 = unreachable), on the device the distances were
    computed on: the card for the min-plus build, the CPU for the BFS.
    ``leaf_block`` is the height of the leaf blocks in which the
    simulator packs its port-mask words.
    """

    topo: Topology
    dist_leaf: torch.Tensor        # [N1, N] int16 distances from each leaf
    leaf_rank: np.ndarray          # [N] rank among leaves or -1
    dist_full: Optional[torch.Tensor] = None   # [N, N] (small nets)
    leaf_block: int = 256          # block height of the mask packing
    squarings: int = 0             # minplus launches of the build (0: BFS)


def _pack_mask_block(dist_block: np.ndarray, nbrs: np.ndarray,
                     valid: np.ndarray, nbr_safe: np.ndarray):
    """One ``(min, away)`` uint32 block [B, N, W] for a leaf slice: the
    reference's numpy packing, the host version of the device words."""
    p = nbrs.shape[1]
    d = dist_block                                        # [B, N]
    dn = d[:, nbr_safe]                                   # [B, N, P]
    toward = valid[None] & (dn == (d[:, :, None] - 1))
    away = valid[None] & (dn == (d[:, :, None] + 1))
    # port j contributes bit j%32 of word j//32; the bits are distinct
    # within a word, so the segmented sum IS the OR
    shifts = np.uint32(1) << (np.arange(p, dtype=np.uint32) % np.uint32(32))
    starts = np.arange(0, p, 32)
    min_b = np.add.reduceat(toward * shifts, starts, axis=2)
    away_b = np.add.reduceat(away * shifts, starts, axis=2)
    return min_b.astype(np.uint32, copy=False), \
        away_b.astype(np.uint32, copy=False)


def build_tables(topo: Topology, full: bool = False, *,
                 leaf_block: int = 256, device=None) -> RoutingTables:
    """Leaf distance tables for ``topo``.

    ``device`` picks where the distances are computed and kept: a CUDA
    device squares the adjacency matrix there (:func:`minplus_distances`)
    and keeps the int16 rows on the card; no device or the CPU runs
    :func:`bfs_distances` on the host.  Either way the rows equal the
    reference's ``dist_leaf`` element for element.
    """
    squarings = 0
    if device is not None and torch.device(device).type == "cuda":
        d, squarings = minplus_distances(topo, torch.device(device))
        dist_leaf = _hops_int16(d[torch.as_tensor(topo.leaf_ids,
                                                  device=d.device).long()])
        dist_full = _hops_int16(d) if full else None
    else:
        dist_leaf = torch.from_numpy(bfs_distances(topo, topo.leaf_ids))
        dist_full = (torch.from_numpy(
            bfs_distances(topo, np.arange(topo.n_switches)))
            if full else None)
    return RoutingTables(topo, dist_leaf, topo.leaf_rank(), dist_full,
                         leaf_block=leaf_block, squarings=squarings)
