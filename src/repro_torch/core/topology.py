"""Switch-level topologies: the MRLS fabric of the paper (Cano et al.,
2026) and the fabrics it is compared with.

The port's own copy of the reference's numpy constructors: for the same
arguments and seed they give identical ``nbrs`` and ``nbr_port`` arrays,
so both simulators run on one fabric.

  * :func:`mrls`          -- Multipass Random Leaf-Spine (Definition 4.1)
  * :func:`rfc`           -- 2-level Random Folded Clos (an MRLS of diameter 2)
  * :func:`fat_tree`      -- folded-Clos Fat-Tree (+ depopulation)
  * :func:`oft`           -- 2-level Orthogonal Fat-Tree from PG(2, q)
  * :func:`dragonfly`     -- canonical balanced Dragonfly
  * :func:`dragonfly_plus`-- Dragonfly+
  * :func:`jellyfish`     -- random regular graph fabric
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

__all__ = ["Topology", "mrls", "rfc", "fat_tree", "oft", "dragonfly",
           "dragonfly_plus", "jellyfish"]


@dataclasses.dataclass
class Topology:
    """A switch-level graph with endpoint bookkeeping.

    ``nbrs[c, p]`` is the switch reached by port ``p`` of switch ``c`` (or -1
    for an unused port).  ``nbr_port[c, p]`` is the port index *on that
    neighbor* that the link lands on — needed by the simulator to address the
    receiving input queue.  Multi-edges (parallel links) are allowed; each
    occupies distinct ports on both sides.
    """

    name: str
    kind: str                      # "indirect" | "direct"
    nbrs: np.ndarray               # [N, P] int32, -1 padded
    nbr_port: np.ndarray           # [N, P] int32, -1 padded
    is_leaf: np.ndarray            # [N] bool — switches with endpoints
    endpoints_per_leaf: int        # d
    level: np.ndarray              # [N] int32, 0 = leaf level
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_switches(self) -> int:
        return int(self.nbrs.shape[0])

    @property
    def max_ports(self) -> int:
        return int(self.nbrs.shape[1])

    @property
    def leaf_ids(self) -> np.ndarray:
        return np.nonzero(self.is_leaf)[0].astype(np.int32)

    @property
    def n_leaves(self) -> int:
        return int(self.is_leaf.sum())

    @property
    def n_endpoints(self) -> int:
        return self.n_leaves * self.endpoints_per_leaf

    @property
    def n_links(self) -> int:
        """M — number of bidirectional switch-to-switch links."""
        return int((self.nbrs >= 0).sum()) // 2

    @property
    def degrees(self) -> np.ndarray:
        return (self.nbrs >= 0).sum(axis=1).astype(np.int32)

    def leaf_rank(self) -> np.ndarray:
        """[N] int32: rank of each switch among leaves (-1 for non-leaf)."""
        r = np.full(self.n_switches, -1, np.int32)
        r[self.leaf_ids] = np.arange(self.n_leaves, dtype=np.int32)
        return r

    def validate(self) -> None:
        """Structural invariants: reciprocal links, consistent padding."""
        n, p = self.nbrs.shape
        used = self.nbrs >= 0
        if self.nbr_port.shape != (n, p):
            raise ValueError("nbr_port shape differs from nbrs")
        if not ((self.nbr_port[used] >= 0).all()
                and (~used == (self.nbr_port < 0)).all()):
            raise ValueError("nbr_port padding differs from nbrs")
        c, pt = np.nonzero(used)
        dst, dpt = self.nbrs[c, pt], self.nbr_port[c, pt]
        if not (self.nbrs[dst, dpt] == c).all():
            raise ValueError("non-reciprocal link")
        if not (self.nbr_port[dst, dpt] == pt).all():
            raise ValueError("port mismatch")
        if not self.is_leaf.any():
            raise ValueError("topology has no leaf switch")


def _from_edges(
    name: str,
    kind: str,
    n_switches: int,
    edges: np.ndarray,          # [M, 2] int
    is_leaf: np.ndarray,
    endpoints_per_leaf: int,
    level: np.ndarray,
    max_ports: Optional[int] = None,
    meta: Optional[dict] = None,
) -> Topology:
    edges = np.asarray(edges, np.int64)
    deg = np.zeros(n_switches, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    P = int(deg.max()) if max_ports is None else max_ports
    nbrs = np.full((n_switches, P), -1, np.int32)
    nbr_port = np.full((n_switches, P), -1, np.int32)
    cursor = np.zeros(n_switches, np.int64)
    # sequential port assignment (python loop is fine at build time)
    for a, b in edges:
        pa, pb = cursor[a], cursor[b]
        nbrs[a, pa], nbrs[b, pb] = b, a
        nbr_port[a, pa], nbr_port[b, pb] = pb, pa
        cursor[a], cursor[b] = pa + 1, pb + 1
    topo = Topology(
        name=name,
        kind=kind,
        nbrs=nbrs,
        nbr_port=nbr_port,
        is_leaf=np.asarray(is_leaf, bool),
        endpoints_per_leaf=int(endpoints_per_leaf),
        level=np.asarray(level, np.int32),
        meta=meta or {},
    )
    topo.validate()
    return topo


def mrls(
    n_leaves: int,
    u: int,
    d: int,
    seed: int = 0,
    dedup_passes: int = 40,
    name: Optional[str] = None,
) -> Topology:
    """Multipass Random Leaf-Spine network (Definition 4.1).

    ``n_leaves`` leaf switches with ``d`` endpoint ports and ``u`` up-links;
    spines have ``R = u + d`` down-links.  Requires ``u * n_leaves % R == 0``
    (the paper's ``u N1 = R N2``).  Wiring is a random bipartite matching of
    port stubs (configuration model) with parallel-edge reduction via edge
    swaps.
    """
    R = u + d
    if (u * n_leaves) % R != 0:
        raise ValueError(f"u*N1 = {u * n_leaves} must be divisible by R = {R}")
    n_spines = (u * n_leaves) // R
    rng = np.random.default_rng(seed)

    leaf_stubs = np.repeat(np.arange(n_leaves), u)
    spine_stubs = np.repeat(np.arange(n_spines), R)
    rng.shuffle(spine_stubs)
    pairs = np.stack([leaf_stubs, spine_stubs], axis=1)  # [u*N1, 2]

    # reduce parallel edges by re-shuffling duplicate stubs together with a
    # random set of partners (a permutation preserves the degree sequence).
    for _ in range(dedup_passes):
        key = pairs[:, 0].astype(np.int64) * n_spines + pairs[:, 1]
        order = np.argsort(key, kind="stable")
        sk = key[order]
        dup_pos = order[1:][sk[1:] == sk[:-1]]
        if dup_pos.size == 0:
            break
        partners = rng.integers(0, pairs.shape[0], size=2 * dup_pos.size)
        swap = np.unique(np.concatenate([dup_pos, partners]))
        pairs[swap, 1] = pairs[rng.permutation(swap), 1]

    edges = np.stack([pairs[:, 0], n_leaves + pairs[:, 1]], axis=1)
    n = n_leaves + n_spines
    is_leaf = np.zeros(n, bool)
    is_leaf[:n_leaves] = True
    level = np.where(is_leaf, 0, 1).astype(np.int32)
    return _from_edges(
        name or f"MRLS(R={R},S={n_leaves * d},u={u})",
        "indirect",
        n,
        edges,
        is_leaf,
        d,
        level,
        max_ports=R,
        meta={"u": u, "d": d, "R": R, "n_leaves": n_leaves, "n_spines": n_spines,
              "f": u / d, "seed": seed},
    )


def rfc(n_leaves: int, u: int, d: int, seed: int = 0, max_tries: int = 20) -> Topology:
    """2-level Random Folded Clos: an MRLS re-rolled until it is up/down
    connected (leaf-leaf diameter 2), the regime where classic RFC routing
    works.  Raises if the size is beyond the D=2 threshold (see Fig. 3)."""
    from .routing import bfs_distances  # local import to avoid cycle

    for t in range(max_tries):
        topo = mrls(n_leaves, u, d, seed=seed + t, name=f"RFC(R={u+d},S={n_leaves*d})")
        dist = bfs_distances(topo, topo.leaf_ids)
        if dist[:, topo.leaf_ids].max() <= 2:
            topo.meta["rerolls"] = t
            return topo
    raise ValueError("network too large for up/down (D=2) connectivity — use mrls()")


# ---------------------------------------------------------------------- #
# Fat-Tree (folded Clos, Section 2.1.1)
# ---------------------------------------------------------------------- #
def fat_tree(radix: int, h: int, a1: Optional[int] = None) -> Topology:
    """Non-blocking folded-Clos Fat-Tree of height ``h`` (h+1 switch levels).

    Built as a mixed-radix n-tree: endpoints are addressed by digits
    ``(a_1, a_2, .., a_h)`` with ``a_1 in [A1]`` (default ``A1 = radix``) and
    ``a_i in [k]``, ``k = radix / 2``.  A level-``l`` switch is
    ``(a_1..a_{h-l}, p_1..p_l)``; its up-port ``p`` connects to
    ``(a_1..a_{h-l-1}, p_1..p_l, p)``.  Leaves have ``k`` endpoints.

    * full tree: ``a1 = radix`` (=2k) -> S = 2 k^{h+1}, the paper's formula.
    * 50% depopulated (paper's ``FT(36, 104976) 50% pop.``): ``a1 = k`` —
      half the pods built out, root level kept at full relative size.
    """
    k = radix // 2
    if radix % 2:
        raise ValueError("radix must be even")
    A1 = radix if a1 is None else a1

    # enumerate switches level by level; address -> id maps.
    def level_count(l: int) -> int:
        if l == h:
            return k ** h
        return A1 * k ** (h - 1)  # a_1 * k^(h-l-1) * k^l

    offsets = np.cumsum([0] + [level_count(l) for l in range(h + 1)])
    n = int(offsets[-1])

    def sid(l: int, a_digits: tuple, p_digits: tuple) -> int:
        # a_digits: (a_1..a_{h-l}); p_digits: (p_1..p_l)
        idx = 0
        if l < h:
            idx = a_digits[0]
            for d_ in a_digits[1:]:
                idx = idx * k + d_
        for d_ in p_digits:
            idx = idx * k + d_
        return int(offsets[l] + idx)

    edges = []
    for l in range(h):
        a_len = h - l
        a_space = itertools.product(range(A1), *([range(k)] * (a_len - 1)))
        for a in a_space:
            for p_ in itertools.product(*([range(k)] * l)):
                me = sid(l, a, p_)
                for p in range(k):
                    up = sid(l + 1, a[:-1], p_ + (p,))
                    edges.append((me, up))
    edges = np.asarray(edges, np.int64)
    is_leaf = np.zeros(n, bool)
    is_leaf[: level_count(0)] = True
    level = np.zeros(n, np.int32)
    for l in range(h + 1):
        level[offsets[l]: offsets[l + 1]] = l
    return _from_edges(
        f"FT(R={radix},h={h},S={level_count(0) * k})",
        "indirect",
        n,
        edges,
        is_leaf,
        k,
        level,
        max_ports=radix,
        meta={"radix": radix, "h": h, "k": k, "a1": A1},
    )


# ---------------------------------------------------------------------- #
# Orthogonal Fat-Tree (2-level, from a polarity of PG(2, q))
# ---------------------------------------------------------------------- #
def _pg2_points(q: int) -> np.ndarray:
    """Canonical representatives of the q^2+q+1 points of PG(2, q), q prime."""
    pts = [(1, y, z) for y in range(q) for z in range(q)]
    pts += [(0, 1, z) for z in range(q)]
    pts += [(0, 0, 1)]
    return np.asarray(pts, np.int64)


def _is_prime(q: int) -> bool:
    if q < 2:
        return False
    i = 2
    while i * i <= q:
        if q % i == 0:
            return False
        i += 1
    return True


def oft(q: int) -> Topology:
    """2-level Orthogonal Fat-Tree [6, 7] built from the standard polarity
    (correlation ``x <-> x^perp``) of PG(2, q), q prime.

    * ``N1 = 2(q^2+q+1)`` leaves (point-side + line-side), ``q+1`` up-links,
      ``q+1`` endpoint ports each (R = 2(q+1)).
    * ``N2 = q^2+q+1`` spines; spine ``j`` connects to point-leaves ``p`` with
      ``p . x_j = 0`` and line-side leaves ``L`` with ``x_j in L`` — i.e. each
      spine sees q+1 leaves of each side.  Any two opposite-side leaves share
      a spine => leaf-leaf diameter 2 (paper: D=2, D*=3).
    """
    if not _is_prime(q):
        raise NotImplementedError("oft() supports prime q (the paper uses q=17)")
    pts = _pg2_points(q)                       # [m, 3]
    m = len(pts)                               # q^2+q+1
    # incidence: point i on line j  <=>  pts[i] . pts[j] == 0 (mod q)
    inc = (pts @ pts.T) % q == 0               # [m, m] symmetric
    # leaves: 0..m-1 point-side, m..2m-1 line-side; spines: 2m..3m-1
    edges = []
    pi, li = np.nonzero(inc)
    for a, b in zip(pi, li):
        edges.append((a, 2 * m + b))           # point-leaf a — spine b
        edges.append((m + a, 2 * m + b))       # line-leaf a  — spine b
    n = 3 * m
    is_leaf = np.zeros(n, bool)
    is_leaf[: 2 * m] = True
    level = np.where(is_leaf, 0, 1).astype(np.int32)
    d = q + 1
    return _from_edges(
        f"OFT(R={2 * (q + 1)},S={2 * m * d},q={q})",
        "indirect",
        n,
        np.asarray(edges, np.int64),
        is_leaf,
        d,
        level,
        max_ports=2 * (q + 1),
        meta={"q": q, "n_leaves": 2 * m, "n_spines": m},
    )


# ---------------------------------------------------------------------- #
# Dragonfly and Dragonfly+
# ---------------------------------------------------------------------- #
def dragonfly(a: int, p: int, h: int, n_groups: Optional[int] = None) -> Topology:
    """Canonical Dragonfly [5]: ``g`` groups of ``a`` switches; complete graph
    inside each group; ``h`` global ports per switch; ``p`` endpoints per
    switch.  Balanced max size: ``g = a*h + 1`` with exactly one global link
    between every group pair (palmtree arrangement)."""
    g = (a * h + 1) if n_groups is None else n_groups
    n = g * a
    edges = []
    # intra-group complete graph
    for grp in range(g):
        base = grp * a
        for i in range(a):
            for j in range(i + 1, a):
                edges.append((base + i, base + j))
    # global links: group gi global slot s in [a*h] -> peer group.
    # palmtree: slot s of group gi connects to group (gi + s + 1) mod g.
    if g == a * h + 1:
        for gi in range(g):
            for s in range(a * h):
                gj = (gi + s + 1) % g
                if gi < gj:
                    sw_i = gi * a + (s % a)
                    # peer's slot index: it sees gi at s2 with (gj + s2 + 1) % g == gi
                    s2 = (gi - gj - 1) % g
                    sw_j = gj * a + (s2 % a)
                    edges.append((sw_i, sw_j))
    else:
        raise NotImplementedError("only maximum-size balanced dragonfly")
    is_leaf = np.ones(n, bool)
    level = np.zeros(n, np.int32)
    return _from_edges(
        f"DF(R={p + a - 1 + h},S={n * p})",
        "direct",
        n,
        np.asarray(edges, np.int64),
        is_leaf,
        p,
        level,
        max_ports=a - 1 + h,
        meta={"a": a, "p": p, "h": h, "g": g},
    )


def dragonfly_plus(
    n_groups: int, leaves_per_group: int, spines_per_group: int,
    p: int, global_per_spine: int,
) -> Topology:
    """Dragonfly+ [32]: each group is a complete bipartite leaf-spine;
    spines carry global links, trunked uniformly over peer groups."""
    g = n_groups
    lpg, spg = leaves_per_group, spines_per_group
    n = g * (lpg + spg)

    def leaf_id(grp, i):
        return grp * (lpg + spg) + i

    def spine_id(grp, j):
        return grp * (lpg + spg) + lpg + j

    edges = []
    for grp in range(g):
        for i in range(lpg):
            for j in range(spg):
                edges.append((leaf_id(grp, i), spine_id(grp, j)))
    # global: group pair trunking t = spg*global_per_spine / (g-1)
    total_glob = spg * global_per_spine
    if total_glob % (g - 1) != 0:
        raise ValueError("global links must divide evenly over peer groups")
    trunk = total_glob // (g - 1)
    # distribute: for pair (gi, gj), connect trunk links spread over spines.
    pair_counter = {}
    for gi in range(g):
        for gj in range(gi + 1, g):
            for t in range(trunk):
                idx = pair_counter.get(gi, 0)
                pair_counter[gi] = idx + 1
                idx2 = pair_counter.get(gj, 0)
                pair_counter[gj] = idx2 + 1
                edges.append((spine_id(gi, idx % spg), spine_id(gj, idx2 % spg)))
    is_leaf = np.zeros(n, bool)
    for grp in range(g):
        for i in range(lpg):
            is_leaf[leaf_id(grp, i)] = True
    level = np.where(is_leaf, 0, 1).astype(np.int32)
    return _from_edges(
        f"DF+(R={max(p + spg, lpg + global_per_spine)},S={int(is_leaf.sum()) * p})",
        "indirect",
        n,
        np.asarray(edges, np.int64),
        is_leaf,
        p,
        level,
        meta={"g": g, "lpg": lpg, "spg": spg, "p": p,
              "global_per_spine": global_per_spine, "trunk": trunk},
    )


# ---------------------------------------------------------------------- #
# Jellyfish (random regular graph, Singla et al. — PAPERS.md)
# ---------------------------------------------------------------------- #
def _components(n: int, edges: np.ndarray) -> np.ndarray:
    """Connected-component label per vertex (union-find over edges)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:          # path compression
            parent[x], x = root, parent[x]
        return root

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra
    return np.asarray([find(i) for i in range(n)], np.int64)


def jellyfish(
    n_switches: int,
    r: int,
    d: int,
    seed: int = 0,
    repair_passes: int = 200,
    name: Optional[str] = None,
) -> Topology:
    """Jellyfish random-regular-graph fabric (Singla et al.).

    ``n_switches`` switches, each with ``r`` ports wired to other switches
    and ``d`` endpoint ports (radix ``R = r + d``; every switch is a leaf,
    like the direct-network Dragonfly).  Construction is the configuration
    model — a seeded random perfect matching of the ``n*r`` port stubs —
    followed by two deterministic repair stages:

    * **simple-graph repair**: self-loops and parallel edges are broken by
      double-edge swaps against randomly chosen partner edges (the swap
      preserves every switch's degree);
    * **connectivity repair**: while more than one component remains, an
      edge inside the largest component and an edge inside another
      component are cross-swapped, merging the components without
      changing any degree.

    The whole pipeline draws from one ``np.random.default_rng(seed)``
    stream, so a (n_switches, r, d, seed) tuple names one exact graph.
    """
    if r < 2:
        raise ValueError(f"jellyfish needs r >= 2 network ports, got {r}")
    if r >= n_switches:
        raise ValueError(
            f"r = {r} must be < n_switches = {n_switches} (simple graph)")
    if (n_switches * r) % 2:
        raise ValueError(
            f"n_switches * r = {n_switches * r} must be even (each link "
            "consumes two port stubs)")
    if d < 1:
        raise ValueError(f"jellyfish needs d >= 1 endpoint ports, got {d}")
    rng = np.random.default_rng(seed)

    if r == n_switches - 1:
        # the only simple r-regular graph on n vertices is K_n — the
        # stub-matching repair cannot reach it, so build it directly
        iu = np.triu_indices(n_switches, k=1)
        edges = np.stack([iu[0], iu[1]], axis=1).astype(np.int64)
        return _from_edges(
            name or f"JF(R={r + d},S={n_switches * d},r={r})",
            "direct", n_switches, edges, np.ones(n_switches, bool), d,
            np.zeros(n_switches, np.int32), max_ports=r,
            meta={"r": r, "d": d, "R": r + d, "n_switches": n_switches,
                  "seed": seed})

    stubs = np.repeat(np.arange(n_switches, dtype=np.int64), r)
    rng.shuffle(stubs)
    edges = stubs.reshape(-1, 2)                  # [n*r/2, 2]

    # simple-graph repair: swap away self-loops and duplicate edges.
    for _ in range(repair_passes):
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n_switches + hi
        order = np.argsort(key, kind="stable")
        sk = key[order]
        bad = edges[:, 0] == edges[:, 1]          # self-loops
        bad[order[1:][sk[1:] == sk[:-1]]] = True  # parallel edges
        bad_idx = np.nonzero(bad)[0]
        if bad_idx.size == 0:
            break
        # double-edge swap: (a,b),(c,e) -> (a,e),(c,b).  Partner edges are
        # drawn at random; degrees are preserved unconditionally, and the
        # next pass re-checks whatever the swap produced.
        partners = rng.integers(0, edges.shape[0], size=bad_idx.size)
        for i, j in zip(bad_idx, partners):
            if i == j:
                continue
            edges[i, 1], edges[j, 1] = edges[j, 1], edges[i, 1]
    else:
        raise ValueError(
            f"jellyfish(n={n_switches}, r={r}, seed={seed}) could not be "
            f"repaired to a simple graph in {repair_passes} passes — the "
            "configuration is too dense; raise n_switches or lower r")

    # connectivity repair: cross-swap an in-component edge with an edge of
    # the largest component until one component remains.
    for _ in range(repair_passes):
        comp = _components(n_switches, edges)
        labels, counts = np.unique(comp, return_counts=True)
        if labels.size == 1:
            break
        main = labels[np.argmax(counts)]
        ec = comp[edges[:, 0]]                    # component of each edge
        inside = np.nonzero(ec != main)[0]
        anchor = np.nonzero(ec == main)[0]
        # swap the second endpoints: (a,b) in minor, (c,e) in main ->
        # (a,e),(c,b) bridges the two components, degrees unchanged.
        i = int(inside[rng.integers(0, inside.size)])
        j = int(anchor[rng.integers(0, anchor.size)])
        # avoid manufacturing a self-loop or duplicate; re-draw next pass
        if (edges[i, 0] == edges[j, 1] or edges[j, 0] == edges[i, 1]):
            continue
        edges[i, 1], edges[j, 1] = edges[j, 1], edges[i, 1]
    else:
        raise ValueError(
            f"jellyfish(n={n_switches}, r={r}, seed={seed}) could not be "
            f"connected in {repair_passes} swap passes")

    is_leaf = np.ones(n_switches, bool)
    level = np.zeros(n_switches, np.int32)
    return _from_edges(
        name or f"JF(R={r + d},S={n_switches * d},r={r})",
        "direct",
        n_switches,
        edges,
        is_leaf,
        d,
        level,
        max_ports=r,
        meta={"r": r, "d": d, "R": r + d, "n_switches": n_switches,
              "seed": seed},
    )
