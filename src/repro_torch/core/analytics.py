"""Topology metrics and the paper's analytic machinery.

The port's own copy of the reference's ``core.analytics``: the same
float64 arithmetic in the same order, so every value equals the
reference's.  Only :func:`exact_metrics` differs: it builds its tables
on the card unless the caller asks for the CPU.

Exact metrics (Section 2.2): average distance A, diameter D/D*, capacity
limit Theta = 2M / (S * A)  (Eq. 1), link/switch costs (Eqs. 2-3).

Appendix A: distance-distribution estimation for MRLS via the
coupon-collector neighborhood recurrence (Eqs. 5-6), expected A / A*, and the
D* threshold probabilities (Eqs. 7-9) used to draw the scalability spectrum
(Figs. 3-4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .topology import Topology
from .routing import RoutingTables, build_tables

__all__ = [
    "Metrics", "exact_metrics",
    "mrls_distance_distribution", "mrls_expected_A", "mrls_expected_A_star",
    "prob_dstar_leq", "dstar_thresholds", "mrls_design",
    "theta", "cost_links", "cost_switches",
]


# ---------------------------------------------------------------------- #
# exact metrics
# ---------------------------------------------------------------------- #
def theta(M: int, S: int, A: float) -> float:
    """Capacity limit  Theta = 2M / (S A)   (Eq. 1)."""
    return 2.0 * M / (S * A)


def cost_links(M: int, S: int) -> float:
    return M / S                                             # Eq. 2


def cost_switches(N: int, S: int) -> float:
    return N / S                                             # Eq. 3


@dataclasses.dataclass
class Metrics:
    name: str
    S: int
    N: int
    M: int
    A: float            # avg leaf-leaf distance
    D: int              # leaf-leaf diameter
    D_star: int         # max distance over all switch pairs seen
    theta: float
    cost_links: float
    cost_switches: float

    def row(self) -> str:
        return (f"{self.name:>26s}  S={self.S:<7d} N={self.N:<6d} M={self.M:<7d} "
                f"A={self.A:5.3f} D={self.D} D*={self.D_star} "
                f"Θ={self.theta:5.3f} C_l={self.cost_links:5.3f} C_s={self.cost_switches:5.3f}")


def exact_metrics(topo: Topology, tables: Optional[RoutingTables] = None,
                  full: bool = False, *, device=None) -> Metrics:
    """S, N, M, A, D, D* and the costs of ``topo``.  Without ``tables``
    they are built on ``device``: the card by default (``minplus_hops``),
    the host BFS with ``device="cpu"``; ``full`` adds the all-switch rows
    that D* is then taken over."""
    tables = tables or build_tables(topo, full=full, device=device)
    A = tables.avg_distance_leaf
    S, N, M = topo.n_endpoints, topo.n_switches, topo.n_links
    return Metrics(
        name=topo.name, S=S, N=N, M=M, A=A,
        D=tables.diameter_leaf, D_star=tables.diameter_star,
        theta=theta(M, S, A),
        cost_links=cost_links(M, S),
        cost_switches=cost_switches(N, S),
    )


# ---------------------------------------------------------------------- #
# Appendix A.1 — distance distribution via coupon-collector recurrence
# ---------------------------------------------------------------------- #
def _eta(x: float, n1_i: float, n_next: float) -> float:
    """Expected neighborhood size  eta_i(x) = N_{i+1} (1 - exp(-x n1_i / N_{i+1}))
    (Eq. 6, from Kan's martingale coupon-collector bound [35])."""
    return n_next * (1.0 - math.exp(-x * n1_i / n_next))


def mrls_distance_distribution(
    n1: int, n2: int, u: int, R: int, r_max: int = 24,
) -> dict:
    """Expected sphere sizes n_r^i and ball sizes b_r^i for i in {1, 2}
    (leaf-centered and spine-centered), per Appendix A.1.

    Level sizes: N_1 = n1 leaves (degree u), N_2 = n2 spines (degree R).
    Balls alternate level: a ball of radius r centered at level i lives at
    level (i + r) mod 2 — so the growth step uses the branching factor and
    target-level size of the *current* frontier level.
    """
    N = {1: float(n1), 2: float(n2)}
    deg = {1: float(u), 2: float(R)}

    out = {}
    for i in (1, 2):
        b = [1.0]                      # b_0 = 1
        n_r = [1.0]                    # n_0 = 1
        for r in range(r_max):
            cur_level = 1 + ((i + r + 1) % 2)   # level of frontier at radius r
            nxt_level = 1 + ((i + r) % 2)       # level reached at radius r+1
            grown = _eta(b[r], deg[cur_level], N[nxt_level])
            b.append(min(grown, N[nxt_level]))
            if r + 1 >= 2:
                n_r.append(max(b[r + 1] - b[r - 1], 0.0))
            else:
                n_r.append(b[r + 1])
        out[i] = {"b": np.asarray(b), "n": np.asarray(n_r)}
    return out


def mrls_expected_A(n1: int, n2: int, u: int, R: int) -> float:
    """Expected leaf-leaf average distance  A = (1/(N1-1)) sum 2i * n_{2i}^1."""
    dist = mrls_distance_distribution(n1, n2, u, R)
    n = dist[1]["n"]
    total, weight = 0.0, 0.0
    for r in range(2, len(n), 2):
        total += r * n[r]
        weight += n[r]
    # normalize by realized mass (clip against N1-1 for tiny truncation error)
    return total / max(weight, 1e-12)


def mrls_expected_A_star(n1: int, n2: int, u: int, R: int) -> float:
    """A* over all ordered switch pairs: start from both leaf and spine."""
    dist = mrls_distance_distribution(n1, n2, u, R)
    total, weight = 0.0, 0.0
    for i, cnt in ((1, n1), (2, n2)):
        n = dist[i]["n"]
        for r in range(1, len(n)):
            total += cnt * r * n[r]
            weight += cnt * n[r]
    return total / max(weight, 1e-12)


# ---------------------------------------------------------------------- #
# Appendix A.2/A.3 — D* thresholds
# ---------------------------------------------------------------------- #
def _log_p_empty(x: float, y: float, n: float) -> float:
    """log P[X ∩ Y = ∅] for random x- and y-subsets of an n-set (Eq. 9),
    via log-gamma so it works for the fractional expectations of App. A.1."""
    x, y = min(x, n), min(y, n)
    if x + y >= n:
        return -math.inf
    return (math.lgamma(n - x + 1) + math.lgamma(n - y + 1)
            - math.lgamma(n - x - y + 1) - math.lgamma(n + 1))


def prob_dstar_leq(n1: int, n2: int, u: int, R: int, k: int) -> float:
    """P[D* <= k]  (Eq. 8).

    Considers pairs (s leaf, t leaf) for odd k and (s leaf, t spine) for even
    k, testing S_1(s) ∩ S_{k-2}(t) = ∅ at the spine level (the paper's most
    precise choice i=1)."""
    if k < 2:
        return 0.0
    dist = mrls_distance_distribution(n1, n2, u, R)
    # Y is the parity BALL B_{k-2}(t) (spine-level switches within k-2 of t):
    # d(s,t) <= k-1 iff S_1(s) intersects it.  The paper's Eq. (7) uses the
    # sphere S_{k-2}(t); ball == sphere-dominated in the threshold regime,
    # and the ball stays exact once the distribution saturates (P -> 1).
    if k % 2 == 1:            # t leaf — both endpoints leaves
        G = n1 * (n1 - 1) / 2.0
        y = float(dist[1]["b"][k - 2])
    else:                     # t spine
        G = float(n1) * n2
        y = float(dist[2]["b"][k - 2])
    x = float(u)              # |S_1(s)|, s leaf
    log_p = _log_p_empty(x, y, float(n2))
    lam = G * math.exp(log_p) if log_p > -700 else 0.0
    return math.exp(-lam)


def mrls_design(S: int, R: int, f: float) -> tuple[int, int, int, int]:
    """Pick (n1, n2, u, d) for a target endpoint count S, radix R, thickness
    f = u/d.  Exact divisibility is relaxed (fine-grain scalability means any
    nearby size works; we round to the nearest valid instance)."""
    d = max(1, round(R / (1.0 + f)))
    u = R - d
    n1 = max(2, round(S / d))
    # u*n1 must be divisible by R for integral spine count: round n1 up.
    while (u * n1) % R:
        n1 += 1
    n2 = (u * n1) // R
    return n1, n2, u, d


def dstar_thresholds(R: int, f: float, k_max: int = 8,
                     s_lo: float = 1e2, s_hi: float = 1e9) -> dict[int, float]:
    """Endpoint count S at which P[D* <= k] = 1/2 (the region boundaries of
    Fig. 3), found by bisection over S for each k."""
    out = {}
    for k in range(2, k_max + 1):
        lo, hi = s_lo, s_hi
        def p_of(s):
            n1, n2, u, d = mrls_design(int(s), R, f)
            return prob_dstar_leq(n1, n2, u, R, k)
        if p_of(lo) < 0.5:
            continue                       # threshold below range
        if p_of(hi) > 0.5:
            out[k] = math.inf
            continue
        for _ in range(80):
            mid = math.sqrt(lo * hi)
            if p_of(mid) >= 0.5:
                lo = mid
            else:
                hi = mid
        out[k] = math.sqrt(lo * hi)
    return out
