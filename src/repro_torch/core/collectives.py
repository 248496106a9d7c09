"""Collective-communication workloads (Section 5.2.3 of the paper).

The port's own copy of the reference's ``repro.core.collectives``, equal
to it phase for phase.

These produce *endpoint message programs* consumed by the simulator:

* :func:`all2all_rounds` — the All2All collective: round ``r`` pairs endpoint
  ``i`` with ``(i + r + 1) mod S`` (classic shifted exchange).  The paper runs
  the full ``S-1`` rounds; at 100K endpoints that is ~10^10 packets, so the
  benchmark scales the number of rounds (still globally uniform, completion
  bound) and reports ratios — see EXPERIMENTS.md.
* :func:`rabenseifner_phases` — Allreduce via Rabenseifner's algorithm [33]:
  recursive-halving reduce-scatter then recursive-doubling all-gather, with
  per-phase message sizes and XOR partners.  Ranks map linearly onto
  endpoints, so low-order-bit partners share a leaf switch — the locality
  that favors Fat-Trees (Section 6.1.3).

Also closed-form lower bounds used as sanity checks and by the fabric
planner (the reference's ``repro.fabric``; the port's comes later).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "all2all_rounds",
    "rabenseifner_phases",
    "ring_allreduce_phases",
    "recursive_doubling_phases",
    "all2all_lower_bound_slots",
    "allreduce_lower_bound_slots",
]


def all2all_rounds(S: int, n_rounds: int) -> np.ndarray:
    """[n_rounds, S] destination endpoint of endpoint ``i`` in round ``r``."""
    i = np.arange(S, dtype=np.int64)
    return np.stack([(i + r + 1) % S for r in range(n_rounds)], axis=0)


def rabenseifner_phases(n_ranks: int, vec_packets: int) -> list[dict]:
    """Phases for Rabenseifner's Allreduce over ``n_ranks`` (power of two).

    Returns a list of phases; each phase is
    ``{"partner": [S] endpoint ids, "packets": int}``.
    Message sizes: reduce-scatter phase p sends ``vec / 2^{p+1}``; all-gather
    phase p sends ``vec / 2^{log-p}`` — clamped to >= 1 packet when the
    (scaled) vector no longer divides.
    """
    log = int(np.log2(n_ranks))
    assert 2 ** log == n_ranks, "Rabenseifner requires power-of-two ranks"
    i = np.arange(n_ranks, dtype=np.int64)
    phases = []
    for p in range(log):                      # reduce-scatter (halving)
        phases.append({
            "partner": i ^ (1 << p),
            "packets": max(1, vec_packets >> (p + 1)),
        })
    for p in range(log):                      # all-gather (doubling)
        phases.append({
            "partner": i ^ (1 << (log - 1 - p)),
            "packets": max(1, vec_packets >> (log - p)),
        })
    return phases


def ring_allreduce_phases(n_ranks: int, vec_packets: int) -> list[dict]:
    """Phases for ring Allreduce over ``n_ranks`` (any count >= 2).

    ``2 * (n - 1)`` steps (reduce-scatter ring then all-gather ring); every
    step sends one ``vec / n`` chunk (clamped to >= 1 packet) to the next
    rank on the ring.  Bandwidth-optimal but latency-heavy — the classic
    counterpoint to Rabenseifner's log-depth schedule.
    """
    assert n_ranks >= 2, "ring allreduce needs at least 2 ranks"
    i = np.arange(n_ranks, dtype=np.int64)
    step = {"partner": (i + 1) % n_ranks,
            "packets": max(1, vec_packets // n_ranks)}
    return [dict(step) for _ in range(2 * (n_ranks - 1))]


def recursive_doubling_phases(n_ranks: int, vec_packets: int) -> list[dict]:
    """Phases for recursive-doubling Allreduce over ``n_ranks`` (power of
    two): ``log2(n)`` XOR-partner exchanges of the *full* vector —
    latency-optimal, bandwidth-redundant (the other end of the trade-off
    from :func:`ring_allreduce_phases`).
    """
    log = int(np.log2(n_ranks))
    assert 2 ** log == n_ranks, "recursive doubling requires power-of-two ranks"
    i = np.arange(n_ranks, dtype=np.int64)
    return [{"partner": i ^ (1 << p), "packets": max(1, vec_packets)}
            for p in range(log)]


# ---------------------------------------------------------------------- #
# closed-form bounds (used as sanity floors & by the fabric planner)
# ---------------------------------------------------------------------- #
def all2all_lower_bound_slots(S: int, n_rounds: int, theta: float) -> float:
    """Each endpoint must send+receive ``n_rounds`` packets; the fabric
    sustains at most ``min(1, theta)`` packets/slot/endpoint under uniform
    traffic (Eq. 1)."""
    return n_rounds / min(1.0, theta)


def allreduce_lower_bound_slots(n_ranks: int, vec_packets: int, theta: float) -> float:
    total = sum(ph["packets"] for ph in rabenseifner_phases(n_ranks, vec_packets))
    return total / min(1.0, theta)
