"""Routing tables for randomly-wired indirect networks (Section 4.3).

The port's own copy of the reference's table build: hop distances from
every leaf, as int16 rows equal to the reference's ``dist_leaf``.  The
device picks how they are computed.  On the host (``device="cpu"``)
they come from a BFS over blocks of sources; on the card from
min-plus squaring of the int16 hop adjacency through the CUDA
``minplus_hops`` kernel (:func:`hop_distances`,
``repro_torch.kernels.minplus``), which gives the same table and leaves
it on the card.  :func:`minplus_distances` is the float32 form of the
same powering, the counterpart of the reference's
``all_pairs_distances``.  The simulator packs its port-mask words from
these rows on its own device (:func:`pack_mask_block`);
:func:`_pack_mask_block` is the reference's numpy packing, kept as the
host version that the device words are checked against.
:func:`route_packet_host`, :func:`polarized_port_mask` and
:func:`find_corners` are the reference's host router in numpy (one
packet switch by switch, and the Polarized corner count).

Failures: :meth:`RoutingTables.apply_failures` takes links and switches
down (and back up) and rebuilds only the leaf rows whose distances can
change, in place, on the device that holds them: on the card through
:func:`hop_distances` (``minplus_hops``) over the *effective* adjacency,
on the CPU through the BFS.  It returns a :class:`TableDelta` with the
new rows, their mask words and the liveness masks, which the simulator
scatters into its state (``Simulator.update_tables``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.minplus.ops import INF, minplus_hops_op, minplus_op
from ..kernels.minplus.ref import (HOPS_INF, HOPS_LIMIT, adjacency_matrix,
                                   hops_adjacency, minplus_powers,
                                   padded_hops)
from .topology import Topology

__all__ = [
    "bfs_distances",
    "minplus_distances",
    "hop_distances",
    "RoutingTables",
    "TableDelta",
    "build_tables",
    "pack_mask_block",
    "UNREACHABLE",
    "polarized_port_mask",
    "route_packet_host",
    "find_corners",
    "mask_table_bytes",
    "DENSE_MASK_LIMIT",
    "POLICIES",
]

# the routing policies of the engine (and of a search's policy axis)
POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant",
            "degraded")

# the distance of a switch that failures cut off from a leaf: >= 0, far
# above any diameter and far below int16 overflow, so d - 1 / d + 1
# comparisons with real distances are false and hop budgets fail (the
# reference's value)
UNREACHABLE = 16384

# the reference's bound on one dense [N1, N, W] numpy mask table, past
# which its build streams the masks in leaf blocks.  The port keeps one
# layout (the simulator packs the words on its own device), so the
# constant only names the layout the reference's estimate reports
DENSE_MASK_LIMIT = 256 * 1024 * 1024

_I32 = torch.int32


def bfs_distances(topo: Topology, sources: np.ndarray, *,
                  nbrs: Optional[np.ndarray] = None) -> np.ndarray:
    """[len(sources), N] int16 hop distances (-1 = unreachable).

    Level-synchronous BFS over blocks of sources: each hop level expands
    every block member's frontier in one scatter, so the work follows the
    frontier population rather than ``B * N * P``.  ``nbrs`` overrides
    the adjacency (same ``[N, P]`` -1-padded layout): the delta rebuild
    passes the effective adjacency of a fabric with failures.
    """
    nbrs = topo.nbrs if nbrs is None else nbrs
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


# rows of one block of the stopping rule's reduction (bounds its temporaries)
_FINAL_ROWS = 1024


def _rows_final(rows: torch.Tensor, k: int) -> bool:
    """True when every finite entry (below ``HOPS_INF``) of ``rows`` is
    below ``2**k``: after ``k`` squarings the rows cover every path of up
    to ``2**k`` hops, and a shorter-than-``2**k`` maximum means no vertex
    lies at distance ``2**k``, so no shortest path is longer.  One host
    sync."""
    top = [torch.where(blk == HOPS_INF, 0, blk).amax()
           for blk in rows.split(_FINAL_ROWS) if blk.numel()]
    return not top or int(torch.stack(top).max()) < 2 ** k


def hop_distances(nbrs, leaf_ids, device, *, full: bool = False):
    """``(dist_leaf, dist_full, products)``: int16 hop distances from each
    leaf ``[N1, N]`` (and, with ``full``, between all switches ``[N, N]``,
    else None), -1 where unreachable, on ``device``; ``products`` counts
    the ``minplus_hops`` products (kernel launches on the card).

    The switches are relabelled leaves first, so the leaf rows of every
    matrix are its first rows.  From the int16 adjacency ``D_0`` each
    squaring ``D_{k+1} = D_k (min, +) D_k`` is two products: the rows the
    tables need (the leaf rows, rounded up to a multiple of 8; every row
    with ``full``), then the others.  ``D_k`` is symmetric, so the
    k-major operand of a block of its rows is the block of its columns, a
    view.  After the needed rows of a squaring, the stopping rule
    (:func:`_rows_final`) decides: if they are final the build stops and
    the other rows are never computed.  Raises ``ValueError`` on an
    adjacency that is not symmetric, or when a distance reaches
    ``HOPS_LIMIT`` (8,192 hops), past which int16 sums could saturate.
    """
    nbrs = np.asarray(nbrs)
    n = nbrs.shape[0]
    leaf_ids = np.asarray(leaf_ids, np.int64)
    perm = np.concatenate([leaf_ids, np.setdiff1d(np.arange(n), leaf_ids)])
    identity = np.array_equal(perm, np.arange(n))
    if not identity:
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        nb = nbrs[perm]
        nbrs = np.where(nb >= 0, inv[np.maximum(nb, 0)], -1)
    d = hops_adjacency(nbrs, device=device)
    if not torch.equal(d, d.t()):
        raise ValueError("the hop adjacency is not symmetric: the table "
                         "build takes the k-major operand from D's columns "
                         "and needs every link in both directions")
    need = n if full else len(leaf_ids)
    split = min(-(-need // 8) * 8, n)
    nd = padded_hops(n, n, device=device)
    products, k = 0, 0
    done = _rows_final(d[:need], 0)
    while not done:
        if 2 ** k >= HOPS_LIMIT:
            raise ValueError(f"hop distances reach {HOPS_LIMIT} or more: "
                             "past the int16 table build's range")
        minplus_hops_op(d[:, :split], d, out=nd[:split])
        products += 1
        done = _rows_final(nd[:need], k + 1)
        if not done and split < n:
            minplus_hops_op(d[:, split:], d, out=nd[split:])
            products += 1
        d, nd = nd, d
        k += 1
    del nd
    if identity:
        x = d[:need].clone(memory_format=torch.contiguous_format)
    else:
        inv_t = torch.as_tensor(inv, device=d.device)
        x = d[:need][:, inv_t]
        if full:
            x = x[inv_t]
    del d
    x.masked_fill_(x == HOPS_INF, -1)
    if not full:
        return x, None, products
    return x[torch.as_tensor(leaf_ids, device=x.device)], x, products


def _hops_int16(d: torch.Tensor) -> torch.Tensor:
    """float32 min-plus distances -> the BFS's int16 table (-1 where
    unreachable), on the device of ``d``."""
    return torch.where(d >= INF, -1.0, d).to(torch.int16)


@dataclasses.dataclass
class TableDelta:
    """Changed rows and live masks from one
    :meth:`RoutingTables.apply_failures`: the reference's ``TableDelta``,
    its rows as tensors on the device of the tables.

    ``leaf_rows`` indexes the leaf-rank axis; ``dist_rows`` holds the
    rebuilt int16 distance rows of exactly those leaves (``UNREACHABLE``
    where cut off), ``min_rows`` / ``away_rows`` their toward / away mask
    words as int32 views of the uint32 words.  ``link_up`` and
    ``switch_up`` are the *full* current liveness masks.  ``products``
    counts the ``minplus_hops`` products of the rebuild (0 for the BFS).
    """

    leaf_rows: np.ndarray          # [K] int32 affected leaf ranks
    dist_rows: torch.Tensor        # [K, N] int16
    min_rows: torch.Tensor         # [K, N, W] int32 toward-bit words
    away_rows: torch.Tensor        # [K, N, W] int32 away-bit words
    link_up: np.ndarray            # [N, P] bool, directed-port liveness
    switch_up: np.ndarray          # [N] bool
    products: int = 0

    @property
    def n_affected(self) -> int:
        return int(self.leaf_rows.shape[0])


@dataclasses.dataclass
class RoutingTables:
    """Precomputed routing state for the simulator.

    ``dist_leaf`` is an int16 tensor ``[N1, N]`` of hop distances from
    each leaf (-1 = unreachable), on the device the distances were
    computed on: the card for the min-plus build, the CPU for the BFS.
    ``leaf_block`` is the height of the leaf blocks in which the
    simulator packs its port-mask words.  ``dead_ports`` /
    ``dead_switches`` are the failed elements (host bool arrays, made by
    the first :meth:`apply_failures`).
    """

    topo: Topology
    dist_leaf: torch.Tensor        # [N1, N] int16 distances from each leaf
    leaf_rank: np.ndarray          # [N] rank among leaves or -1
    dist_full: Optional[torch.Tensor] = None   # [N, N] (small nets)
    leaf_block: int = 256          # block height of the mask packing
    squarings: int = 0             # minplus_hops products (0: BFS)
    dead_ports: Optional[np.ndarray] = None     # [N, P] bool
    dead_switches: Optional[np.ndarray] = None  # [N] bool

    # the reference's table metrics, each reduced on the device that
    # holds the rows, in blocks of leaf rows (bounded temporaries) and
    # with one host sync
    def _leaf_blocks(self):
        leaves = torch.as_tensor(self.topo.leaf_ids, dtype=torch.int64,
                                 device=self.dist_leaf.device)
        for blk in self.dist_leaf.split(_FINAL_ROWS):
            yield blk[:, leaves]

    @property
    def diameter_leaf(self) -> int:
        return int(torch.stack([b.amax() for b in self._leaf_blocks()])
                   .max())

    @property
    def diameter_star(self) -> int:
        if self.dist_full is not None:
            return int(self.dist_full.max())
        return int(self.dist_leaf.max())       # max over (leaf, any-switch)

    @property
    def avg_distance_leaf(self) -> float:
        """Mean leaf-to-leaf distance over ordered pairs of distinct
        leaves.  The reference sums the integer distances in float64,
        where every partial sum is an integer below 2**53 and so exact;
        an int64 sum divided once in float64 gives its value bit for
        bit."""
        total = torch.stack([b.sum(dtype=torch.int64)
                             for b in self._leaf_blocks()]).sum()
        n1 = len(self.topo.leaf_ids)
        return float(int(total)) / (n1 * (n1 - 1))


    # ------------------------------------------------------------------ #
    # delta rebuilds under failures
    # ------------------------------------------------------------------ #
    def effective_nbrs(self) -> np.ndarray:
        """The adjacency with the failed elements cut out: dead ports, and
        every port of or toward a dead switch, set to -1 (both directions
        of a link die together, so it stays symmetric).  The topology
        itself never changes."""
        nbrs = self.topo.nbrs
        eff = nbrs.copy()
        if self.dead_ports is None:
            return eff
        valid = nbrs >= 0
        switch_up = ~self.dead_switches
        eff[self.dead_ports] = -1
        eff[~switch_up] = -1
        eff[valid & ~switch_up[np.where(valid, nbrs, 0)]] = -1
        return eff

    def apply_failures(self, down=(), up=()) -> TableDelta:
        """Apply link/switch state changes and rebuild only the affected
        leaf rows, as the reference's ``apply_failures`` does.

        ``down`` / ``up`` are iterables of ``FailureEvent`` taking effect
        now.  ``dist_leaf`` is rewritten **in place** on its device.  The
        frontier test is the reference's: a downed link ``{a, b}`` can
        change leaf ``t``'s row only if its farther endpoint keeps no
        other live toward port; a restored link only if
        ``|d(t,a) - d(t,b)| >= 2``; a switch event rebuilds every row.
        It runs in int32 on the rows where they live and syncs with the
        host once, for the affected set.  The rows are rebuilt from the
        affected leaves over :meth:`effective_nbrs`: on the card by
        :func:`hop_distances` (``minplus_hops``), on the CPU by the BFS;
        unreachable switches get ``UNREACHABLE``.  The mask words are
        packed against the **static** adjacency ``topo.nbrs`` by
        :func:`pack_mask_block` on the same device (a toward bit through
        a dead port stays set; the engine's live masks exclude it).
        """
        topo = self.topo
        n, p = topo.n_switches, topo.max_ports
        nbrs = topo.nbrs
        if self.dead_ports is None:
            self.dead_ports = np.zeros((n, p), bool)
            self.dead_switches = np.zeros(n, bool)
        dist = self.dist_leaf
        dev = dist.device
        n1 = dist.shape[0]

        def cols(idx) -> torch.Tensor:
            """int32 distances of every leaf to the switches ``idx``
            (any shape), on the rows' device."""
            idx = np.asarray(idx, np.int64)
            return dist[:, torch.as_tensor(idx.reshape(-1), device=dev)].to(
                _I32).reshape((n1,) + idx.shape)

        every = False
        hit = []                        # [N1] bool terms of the frontier
        down_pairs = []
        for ev in down:
            if ev.kind == "switch":
                self.dead_switches[ev.id] = True
                every = True
                continue
            c, pt = divmod(ev.id, p)
            nb, nbp = int(nbrs[c, pt]), int(topo.nbr_port[c, pt])
            if not self.dead_ports[c, pt]:
                down_pairs.append((c, nb))
            self.dead_ports[c, pt] = True
            self.dead_ports[nb, nbp] = True
        if down_pairs and not every:
            # x = both orientations of every killed link; leaf t is hit
            # iff d(t,x) == d(t,y) + 1 and x keeps no other live toward
            # port (tested against the final dead state, as the reference)
            xs = sorted({x for pair in down_pairs for x in pair})
            xi = {x: i for i, x in enumerate(xs)}
            xa = np.asarray(xs)
            live = (nbrs[xa] >= 0) & ~self.dead_ports[xa]        # [X, P]
            nb_x = np.where(live, nbrs[xa], 0)
            alt = (torch.as_tensor(live, device=dev)[None]
                   & (cols(nb_x) == (cols(xa) - 1)[..., None])).any(2)
            x2 = [x for c, nb in down_pairs for x in (c, nb)]
            y2 = [y for c, nb in down_pairs for y in (nb, c)]
            far = cols(x2) == cols(y2) + 1                       # [N1, 2K]
            at = torch.as_tensor([xi[x] for x in x2], device=dev)
            hit.append((far & ~alt[:, at]).any(1))

        up_pairs = []
        for ev in up:
            if ev.kind == "switch":
                self.dead_switches[ev.id] = False
                every = True
                continue
            c, pt = divmod(ev.id, p)
            nb, nbp = int(nbrs[c, pt]), int(topo.nbr_port[c, pt])
            if self.dead_ports[c, pt]:
                up_pairs.append((c, nb))
            self.dead_ports[c, pt] = False
            self.dead_ports[nb, nbp] = False
        if up_pairs and not every:
            cs = [c for c, _ in up_pairs]
            nbs = [nb for _, nb in up_pairs]
            hit.append(((cols(cs) - cols(nbs)).abs() >= 2).any(1))

        valid = nbrs >= 0
        nbr_safe = np.where(valid, nbrs, 0)
        switch_up = ~self.dead_switches
        link_up = (valid & ~self.dead_ports
                   & switch_up[:, None] & switch_up[nbr_safe])
        if every:
            leaf_rows = np.arange(n1, dtype=np.int32)
        elif hit:
            affected = torch.stack(hit).any(0)
            leaf_rows = affected.nonzero()[:, 0].cpu().numpy().astype(
                np.int32)
        else:
            leaf_rows = np.zeros(0, np.int32)
        k = len(leaf_rows)
        w = (p + 31) // 32
        if k == 0:
            return TableDelta(
                leaf_rows, torch.zeros((0, n), dtype=torch.int16, device=dev),
                torch.zeros((0, n, w), dtype=_I32, device=dev),
                torch.zeros((0, n, w), dtype=_I32, device=dev),
                link_up, switch_up)

        eff = self.effective_nbrs()
        sources = topo.leaf_ids[leaf_rows]
        products = 0
        if dev.type == "cuda":
            rows, _, products = hop_distances(eff, sources, dev)
            rows.masked_fill_(rows < 0, UNREACHABLE)
        else:
            newd = bfs_distances(topo, sources, nbrs=eff)
            rows = torch.from_numpy(
                np.where(newd < 0, UNREACHABLE, newd).astype(np.int16))
        dist.index_copy_(0, torch.as_tensor(leaf_rows.astype(np.int64),
                                            device=dev), rows)

        valid_t = torch.as_tensor(valid, device=dev)
        nbr_safe_t = torch.as_tensor(nbr_safe.astype(np.int64), device=dev)
        min_rows = torch.empty((k, n, w), dtype=_I32, device=dev)
        away_rows = torch.empty_like(min_rows)
        for lo in range(0, k, self.leaf_block):        # bounded scratch
            hi = min(lo + self.leaf_block, k)
            min_rows[lo:hi], away_rows[lo:hi] = pack_mask_block(
                rows[lo:hi], valid_t, nbr_safe_t)
        return TableDelta(leaf_rows, rows, min_rows, away_rows, link_up,
                          switch_up, products)


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


def pack_mask_block(dist_block: torch.Tensor, valid: torch.Tensor,
                    nbr_safe: torch.Tensor, *, away: bool = True):
    """``(min, away)`` int32 words [B, N, W] for a block of int16 leaf
    distance rows ``dist_block`` [B, N]: the reference's
    ``core.routing._pack_mask_block`` on the device, as int32 views of
    its uint32 words (``away`` is None unless asked for).

    ``valid`` [N, P] bool marks the ports with a link, ``nbr_safe``
    [N, P] int64 is the neighbour with -1 mapped to 0.  Port ``j`` sets
    bit ``j % 32`` of word ``j // 32``; the words are built with
    ``bitwise_or`` on int32, where bit 31 is -2**31, so no sum ever
    wraps.  One port at a time keeps the temporaries at [B, N].
    """
    d = dist_block
    p = valid.shape[1]
    min_w = torch.zeros(d.shape + ((p + 31) // 32,), dtype=_I32,
                        device=d.device)
    away_w = torch.zeros_like(min_w) if away else None
    for j in range(p):
        dn = d[:, nbr_safe[:, j]]                               # [B, N]
        bit = np.uint32(1 << (j % 32)).view(np.int32).item()
        min_w[:, :, j // 32].bitwise_or_(
            (valid[:, j] & (dn == d - 1)).to(_I32) * bit)
        if away:
            away_w[:, :, j // 32].bitwise_or_(
                (valid[:, j] & (dn == d + 1)).to(_I32) * bit)
    return min_w, away_w



def mask_table_bytes(n1: int, n: int, p: int) -> int:
    """Bytes of ONE dense ``[N1, N, W]`` uint32 mask table."""
    return n1 * n * ((p + 31) // 32) * 4


def build_tables(topo: Topology, full: bool = False, *,
                 leaf_block: int = 256, device=None) -> RoutingTables:
    """Leaf distance tables for ``topo``.

    ``device`` picks where the distances are computed and kept: the card
    (the default; it raises with no card) squares the int16 hop
    adjacency there with the ``minplus_hops`` kernel
    (:func:`hop_distances`) and keeps the int16 rows on the card;
    ``device="cpu"`` runs :func:`bfs_distances` on the host.  Either way
    the rows equal the reference's ``dist_leaf`` element for element.
    """
    squarings = 0
    device = resolve_device(device)
    if device.type == "cuda":
        dist_leaf, dist_full, squarings = hop_distances(
            topo.nbrs, topo.leaf_ids, device, full=full)
    else:
        dist_leaf = torch.from_numpy(bfs_distances(topo, topo.leaf_ids))
        dist_full = (torch.from_numpy(
            bfs_distances(topo, np.arange(topo.n_switches)))
            if full else None)
    return RoutingTables(topo, dist_leaf, topo.leaf_rank(), dist_full,
                         leaf_block=leaf_block, squarings=squarings)


# ---------------------------------------------------------------------- #
# Polarized port classification and the host-side reference router
# (tests, analytics, corner detection): numpy, the reference's own
# ---------------------------------------------------------------------- #
def polarized_port_mask(d_cs, d_ct, d_ns, d_nt, hops, max_hops, valid):
    """Vectorized Polarized filter on numpy arrays.

    Args are broadcastable: ``d_cs, d_ct, hops`` per packet, ``d_ns, d_nt,
    valid`` per (packet, port).  Returns ``(allowed, is_deroute)`` masks.
    A deroute (Expansion/Contraction) additionally requires that the hop
    budget still admits finishing: ``hops + 1 + d_nt <= max_hops``.
    """
    fwd = (d_ns == d_cs + 1) & (d_nt == d_ct - 1)
    exp_ = (d_ns == d_cs + 1) & (d_nt == d_ct + 1) & (d_cs < d_ct)
    con = (d_ns == d_cs - 1) & (d_nt == d_ct - 1) & (d_cs >= d_ct)
    budget_ok = (hops + 1 + d_nt) <= max_hops
    deroute = exp_ | con
    allowed = valid & (fwd | (deroute & budget_ok))
    return allowed, deroute & valid


def route_packet_host(
    tables: RoutingTables,
    src_leaf: int,
    dst_leaf: int,
    policy: str = "polarized",
    max_hops: Optional[int] = None,
    occupancy: Optional[np.ndarray] = None,     # [N, P] synthetic load
    rng: Optional[np.random.Generator] = None,
    deroute_penalty: float = 10.0,
) -> list:
    """Route one packet switch by switch on the host; returns the list of
    visited switches (src and dst included).  Raises RuntimeError on a
    *corner* (no allowed port, Section 4.3.2) or when the hop budget runs
    out.  The distances come to the host from wherever ``tables`` holds
    them; the draws of ``rng`` are the reference's, so the same ``rng``
    gives the same path."""
    if max_hops is None:
        max_hops = _default_max_hops(tables, policy)
    return _route_packet(tables.topo, tables.dist_leaf.cpu().numpy(),
                         tables.leaf_rank, src_leaf, dst_leaf, policy,
                         max_hops, occupancy, rng, deroute_penalty)


def _default_max_hops(tables: RoutingTables, policy: str) -> int:
    return (2 * tables.diameter_star - 2 if policy == "polarized"
            else tables.diameter_leaf)


def _route_packet(topo, dist: np.ndarray, lr: np.ndarray, src_leaf: int,
                  dst_leaf: int, policy: str, max_hops: int,
                  occupancy: Optional[np.ndarray],
                  rng: Optional[np.random.Generator],
                  deroute_penalty: float) -> list:
    """:func:`route_packet_host` on a host copy ``dist`` of the leaf-row
    distances and a resolved ``max_hops``."""
    s, t = lr[src_leaf], lr[dst_leaf]
    assert s >= 0 and t >= 0, "src/dst must be leaves"
    rng = rng or np.random.default_rng(0)
    occ = (occupancy if occupancy is not None
           else np.zeros_like(topo.nbrs, np.float64))

    path = [src_leaf]
    cur, hops = src_leaf, 0
    mid = None
    if policy in ("valiant", "ugal"):
        mid = int(rng.choice(topo.leaf_ids))
        if policy == "ugal":       # UGAL-L: Valiant only if MIN looks busier
            min_ports = np.nonzero(
                (topo.nbrs[cur] >= 0)
                & (dist[t, topo.nbrs[cur]] == dist[t, cur] - 1))[0]
            val_ports = np.nonzero(
                (topo.nbrs[cur] >= 0)
                & (dist[lr[mid], topo.nbrs[cur]]
                   == dist[lr[mid], cur] - 1))[0]
            q_min = occ[cur, min_ports].min() if min_ports.size else np.inf
            q_val = occ[cur, val_ports].min() if val_ports.size else np.inf
            d_min, d_val = dist[t, cur], dist[lr[mid], cur] + dist[t, mid]
            if q_min * d_min <= q_val * d_val:
                mid = None        # go minimal
    target_rank = t if mid is None else lr[mid]

    while cur != dst_leaf:
        if hops >= max_hops:
            raise RuntimeError(f"hop budget exhausted at {cur} ({policy})")
        nb = topo.nbrs[cur]
        valid = nb >= 0
        nb_safe = np.where(valid, nb, 0)
        if policy == "polarized":
            allowed, deroute = polarized_port_mask(
                dist[s, cur], dist[t, cur],
                dist[s, nb_safe], dist[t, nb_safe],
                hops, max_hops, valid)
            if not allowed.any():
                raise RuntimeError(f"corner at switch {cur} for pair "
                                   f"({src_leaf},{dst_leaf})")
            score = (occ[cur] + deroute_penalty * deroute
                     + rng.uniform(0, 1e-6, nb.shape))
            score = np.where(allowed, score, np.inf)
            port = int(np.argmin(score))
        else:
            # minimal (adaptive / random) toward the current target
            min_mask = valid & (dist[target_rank, nb_safe]
                                == dist[target_rank, cur] - 1)
            if not min_mask.any():
                raise RuntimeError(f"no minimal port at {cur}")
            ports = np.nonzero(min_mask)[0]
            if policy == "ksp":
                port = int(rng.choice(ports))      # randomized minimal walk
            else:                                  # the adaptive policies
                port = int(ports[np.argmin(occ[cur, ports])])
        cur = int(topo.nbrs[cur, port])
        hops += 1
        path.append(cur)
        if mid is not None and cur == mid:
            mid = None
            target_rank = t
    return path


def find_corners(tables: RoutingTables, n_samples: int = 2000,
                 seed: int = 0) -> int:
    """Sample (s, t) leaf pairs and count Polarized routing failures
    (corners).  The paper re-rolls the MRLS if any corner exists; for
    random topologies the probability is negligible (Section 4.3.2)."""
    rng = np.random.default_rng(seed)
    topo = tables.topo
    leaves = topo.leaf_ids
    dist = tables.dist_leaf.cpu().numpy()      # one copy for every sample
    max_hops = _default_max_hops(tables, "polarized")
    corners = 0
    for _ in range(n_samples):
        a, b = rng.choice(leaves, 2, replace=False)
        try:
            _route_packet(topo, dist, tables.leaf_rank, int(a), int(b),
                          "polarized", max_hops, None, rng, 10.0)
        except RuntimeError:
            corners += 1
    return corners
