"""Pareto layer: dominance over (throughput up, link cost down), the
reference's ``repro.search.pareto``.

The search's committed artifact is a *frontier*, not a single winner —
the paper's design argument is exactly a throughput-vs-cost trade
(Θ vs C_l, Eqs. 1-2), so every fully-evaluated candidate carries a
``dominated`` flag and the record names the non-dominated subset.

Candidate ``a`` dominates ``b`` when ``a.throughput >= b.throughput``
and ``a.cost_links <= b.cost_links`` with at least one strict — the
standard weak-dominance rule on (maximize throughput, minimize cost).
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["dominated_flags", "frontier_ids"]


def _dominates(a: dict, b: dict) -> bool:
    ge = a["throughput"] >= b["throughput"]
    le = a["cost_links"] <= b["cost_links"]
    strict = (a["throughput"] > b["throughput"]
              or a["cost_links"] < b["cost_links"])
    return ge and le and strict


def dominated_flags(points: Sequence[dict]) -> list:
    """``points`` carry ``throughput`` and ``cost_links``; returns one
    bool per point (O(n^2) — search budgets are tens, not millions)."""
    return [any(_dominates(a, b) for a in points if a is not b)
            for b in points]


def frontier_ids(points: Sequence[dict],
                 ids: Optional[Sequence] = None) -> list:
    """Ids (default: indices) of the non-dominated points, sorted by
    ascending link cost so the frontier reads as a curve."""
    if ids is None:
        ids = list(range(len(points)))
    keep = [(p["cost_links"], p["throughput"], i)
            for p, i, dom in zip(points, ids, dominated_flags(points))
            if not dom]
    return [i for _, _, i in sorted(keep, key=lambda t: (t[0], -t[1]))]
