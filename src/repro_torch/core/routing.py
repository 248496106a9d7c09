"""Routing tables for randomly-wired indirect networks (Section 4.3).

The port's own copy of the reference's numpy table build: BFS hop
distances from every leaf, and the packed per-(target leaf, switch)
port bitmasks the engine tests instead of gathering ``[P]``-wide
distance rows.  Word for word the reference's tables, in both the dense
and the blocked (streamed) layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .topology import Topology

__all__ = [
    "bfs_distances",
    "RoutingTables",
    "build_tables",
    "pack_port_masks",
    "iter_port_mask_blocks",
    "mask_table_bytes",
    "MASK_LAYOUTS",
    "DENSE_MASK_LIMIT",
]

MASK_LAYOUTS = ("auto", "dense", "blocked")

# ``masks="auto"`` switches to the blocked (streamed) layout once one dense
# numpy mask table would exceed this many bytes.
DENSE_MASK_LIMIT = 256 * 1024 * 1024


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


@dataclasses.dataclass
class RoutingTables:
    """Precomputed routing state for the simulator.

    ``dist_leaf`` is int16 ``[N1, N]``.  Bit ``p`` of word
    ``min_mask[t, c, p // 32]`` is set iff port ``p`` of switch ``c`` leads
    one hop closer to leaf ``t``; ``away_mask`` is the one-hop-farther
    twin.  With ``mask_layout="blocked"`` the dense arrays are never built
    (``min_mask is None``) and :meth:`mask_blocks` computes leaf blocks on
    the fly; the values are the same word for word.
    """

    topo: Topology
    dist_leaf: np.ndarray          # [N1, N] int16 distances from each leaf
    leaf_rank: np.ndarray          # [N] rank among leaves or -1
    dist_full: Optional[np.ndarray] = None   # [N, N] (small nets)
    min_mask: Optional[np.ndarray] = None    # [N1, N, W] uint32 toward-bits
    away_mask: Optional[np.ndarray] = None   # [N1, N, W] uint32 away-bits
    mask_layout: str = "dense"     # "dense" | "blocked"
    leaf_block: int = 256          # block height of the blocked layout

    def mask_blocks(self, block: Optional[int] = None):
        """Yield ``(lo, hi, min_block, away_block)`` leaf blocks tiling
        ``[0, N1)`` in order, for either layout."""
        block = block or self.leaf_block
        if self.min_mask is not None and self.away_mask is not None:
            n1 = self.min_mask.shape[0]
            for lo in range(0, n1, block):
                hi = min(lo + block, n1)
                yield lo, hi, self.min_mask[lo:hi], self.away_mask[lo:hi]
            return
        yield from iter_port_mask_blocks(self.dist_leaf, self.topo.nbrs,
                                         block)


def _pack_mask_block(dist_block: np.ndarray, nbrs: np.ndarray,
                     valid: np.ndarray, nbr_safe: np.ndarray):
    """One ``(min, away)`` uint32 block [B, N, W] for a leaf slice."""
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


def iter_port_mask_blocks(dist_leaf: np.ndarray, nbrs: np.ndarray,
                          block: int = 256):
    """Stream ``(lo, hi, min_block, away_block)`` leaf blocks without
    materializing the ``[N1, N, W]`` arrays."""
    n1 = dist_leaf.shape[0]
    valid = nbrs >= 0
    nbr_safe = np.where(valid, nbrs, 0)
    for lo in range(0, n1, block):
        hi = min(lo + block, n1)
        min_b, away_b = _pack_mask_block(dist_leaf[lo:hi], nbrs,
                                         valid, nbr_safe)
        yield lo, hi, min_b, away_b


def pack_port_masks(dist_leaf: np.ndarray, nbrs: np.ndarray,
                    leaf_chunk: int = 256):
    """``(min_mask, away_mask)`` — [N1, N, ceil(P/32)] uint32 bitmasks, the
    dense assembly of :func:`iter_port_mask_blocks`."""
    n1, n = dist_leaf.shape
    w = (nbrs.shape[1] + 31) // 32
    min_mask = np.zeros((n1, n, w), np.uint32)
    away_mask = np.zeros((n1, n, w), np.uint32)
    for lo, hi, min_b, away_b in iter_port_mask_blocks(dist_leaf, nbrs,
                                                       leaf_chunk):
        min_mask[lo:hi] = min_b
        away_mask[lo:hi] = away_b
    return min_mask, away_mask


def mask_table_bytes(n1: int, n: int, p: int) -> int:
    """Bytes of ONE dense ``[N1, N, W]`` uint32 mask table."""
    return n1 * n * ((p + 31) // 32) * 4


def build_tables(topo: Topology, full: bool = False, *,
                 masks: str = "auto",
                 leaf_block: int = 256) -> RoutingTables:
    """Distance tables + packed port masks for ``topo``.

    ``masks`` picks the port-mask layout: ``"dense"`` materializes the
    ``[N1, N, W]`` numpy arrays, ``"blocked"`` defers them to streamed
    leaf blocks, and ``"auto"`` uses ``"blocked"`` once one dense table
    would exceed :data:`DENSE_MASK_LIMIT` bytes.
    """
    if masks not in MASK_LAYOUTS:
        raise ValueError(f"unknown mask layout {masks!r}; expected one of "
                         f"{MASK_LAYOUTS}")
    dist_leaf = bfs_distances(topo, topo.leaf_ids)
    dist_full = bfs_distances(topo, np.arange(topo.n_switches)) if full else None
    if masks == "auto":
        dense_bytes = mask_table_bytes(topo.n_leaves, topo.n_switches,
                                       topo.max_ports)
        masks = "dense" if dense_bytes <= DENSE_MASK_LIMIT else "blocked"
    if masks == "dense":
        min_mask, away_mask = pack_port_masks(dist_leaf, topo.nbrs,
                                              leaf_block)
    else:
        min_mask = away_mask = None
    return RoutingTables(topo, dist_leaf, topo.leaf_rank(), dist_full,
                         min_mask, away_mask, mask_layout=masks,
                         leaf_block=leaf_block)
