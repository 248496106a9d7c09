"""The design-space search loop: sample -> prune -> screen -> promote.

The port's ``repro.search.loop``, run over the port's ``run`` and
:class:`~repro_torch.api.SimulatorCache` on the caller's device (the
card unless ``device="cpu"`` is asked for).  :func:`search` drives one
:class:`SearchSpec` end to end:

1. **Sample** candidates from the (family, radix, f, policy, vcs) space
   — ``random`` draws distinct points from one seeded generator;
   ``evolutionary`` seeds half the budget randomly, then fills the rest
   by mutating one axis of screened elites (ArchGym-shaped agent loop,
   deterministic under the spec seed).
2. **Prune before building** — every candidate is priced by
   :func:`repro_torch.api.memory.estimate_memory` (the reference's
   spec-level price, which ``mem_budget_mib`` is held against) and
   :func:`repro_torch.api.admission.check_admission` (the port's device
   peak against the device's budget); points over either are recorded
   as ``pruned`` and never touch the simulator.
   Design-infeasible points (no valid instance at this endpoint count)
   are recorded as ``invalid``.
3. **Screen** — every admitted candidate runs the spec workload through
   the normal :func:`repro_torch.api.run` path (shared
   :class:`~repro_torch.api.SimulatorCache`) with the cheap
   ``screen_warm``/``screen_measure`` window.
4. **Promote (successive halving)** — the top ``ceil(survivors * n)``
   screened candidates by objective re-run with the full
   ``warm``/``measure`` window *on the same cached simulator* (same
   fabric + route key — no second set-up), and only they enter the
   Pareto layer.

The returned record is the reference's artifact format, field for field,
but for one key: an admitted candidate carries the port's
``predicted_device_bytes`` where the reference's carries
``predicted_rss_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .._device import resolve_device
from ..api.admission import AdmissionError, check_admission
from ..api.memory import estimate_memory
from ..api.registry import network_topology
from ..api.runner import Result, SimulatorCache, run
from ..core.analytics import exact_metrics
from ..workloads.patterns import check_pattern
from .pareto import dominated_flags, frontier_ids
from .space import (Candidate, DesignError, axis_values,
                    candidate_experiment, design_network, space_size)
from .spec import SearchSpec

__all__ = ["search", "search_many"]


# ---------------------------------------------------------------------- #
# sampling
# ---------------------------------------------------------------------- #
def _draw(rng: np.random.Generator, axes: dict) -> Candidate:
    return Candidate(**{name: vals[rng.integers(0, len(vals))]
                        for name, vals in axes.items()})


def _mutate(rng: np.random.Generator, axes: dict,
            parent: Candidate) -> Candidate:
    """Change exactly one axis of ``parent`` to a different value (axes
    with a single value can't mutate and are skipped)."""
    movable = [n for n, vals in axes.items() if len(vals) > 1]
    if not movable:
        return parent
    name = movable[rng.integers(0, len(movable))]
    vals = [v for v in axes[name] if v != getattr(parent, name)]
    value = vals[rng.integers(0, len(vals))]
    return Candidate(**{**parent.to_dict(), name: value})


def _distinct(rng: np.random.Generator, axes: dict, seen: set,
              proposer, tries: int = 64) -> Optional[Candidate]:
    """Draw until unseen; fall back to a fresh random point, then give
    up (space exhausted)."""
    for _ in range(tries):
        cand = proposer()
        if cand not in seen:
            return cand
    for _ in range(tries):
        cand = _draw(rng, axes)
        if cand not in seen:
            return cand
    return None


# ---------------------------------------------------------------------- #
# pricing (the gate before anything is built)
# ---------------------------------------------------------------------- #
def _price(spec: SearchSpec, cand: Candidate, cid: int, *,
           device=None) -> dict:
    """Design + estimate + admission for one candidate on ``device`` —
    no simulator is built (the metrics build the topology's tables
    there).

    Returns the candidate's record with ``status`` one of ``invalid``
    (no instance exists), ``pruned`` (estimator/admission refused it),
    or ``admitted`` (carries the screen-stage experiment under
    ``"_exp"`` for the evaluation stages).
    """
    rec = {"id": cid, **cand.to_dict(), "label": cand.label()}
    try:
        network = design_network(cand, spec.endpoints, seed=spec.seed)
        topo = network_topology(network)
    except (DesignError, ValueError) as e:
        # DesignError: no instance at this point; plain ValueError: the
        # constructor itself refused the designed instance (e.g. a random
        # construction too dense to repair) — both are infeasible points,
        # not search crashes
        rec.update(status="invalid", reason=str(e))
        return rec
    m = exact_metrics(topo, device=device)
    rec.update(params=network.to_dict()["params"],
               n_endpoints=m.S, n_switches=m.N, n_links=m.M,
               cost_links=m.cost_links, theta=m.theta, diameter=m.D)

    exp = candidate_experiment(spec, cand, network, stage="screen")
    est = estimate_memory(exp)
    rec.update(est_total_bytes=est["total_bytes"],
               est_peak_bytes=est["peak_bytes"])

    budget = spec.mem_budget_bytes()
    if budget is not None and est["peak_bytes"] > budget:
        rec.update(status="pruned",
                   reason=(f"estimated resident peak {est['peak_bytes']} B "
                           f"exceeds the spec's mem_budget "
                           f"({budget} B)"))
        return rec
    try:
        decision = check_admission(exp, device=device)
        rec["predicted_device_bytes"] = decision.predicted_bytes
    except AdmissionError as e:
        rec.update(status="pruned", reason=f"admission refused: {e}")
        return rec

    rec.update(status="admitted", _exp=exp)
    return rec


# ---------------------------------------------------------------------- #
# objective
# ---------------------------------------------------------------------- #
def _throughput_of(res: Result) -> float:
    if res.metric == "completion":
        # all2all proxy: rounds packets per endpoint over the completion
        # window -> packets/slot/endpoint, comparable to the windowed
        # throughput metric (0 when the run hit max_slots incomplete)
        if not res.completed or not res.slots:
            return 0.0
        return res.experiment.workload.rounds / float(res.slots)
    return float(res.throughput or 0.0)


def _objective(spec: SearchSpec, rec: dict, throughput: float) -> float:
    if spec.objective == "throughput":
        return throughput
    return throughput / rec["cost_links"] if rec["cost_links"] else 0.0


def _evaluate(spec: SearchSpec, rec: dict, cache: SimulatorCache,
              stage: str, device=None) -> None:
    """Run one stage for an admitted candidate and fold the metrics into
    its record (``rec["screen"]`` / ``rec["full"]``)."""
    exp = rec["_exp"]
    if stage == "full":
        exp = candidate_experiment(
            spec, Candidate.from_dict(rec),
            exp.network, stage="full")
        if (exp.resolved_metric() == "completion"
                and dataclasses.replace(exp, name=rec["_exp"].name)
                == rec["_exp"]):
            # completion runs ignore warm/measure, so promotion would
            # replay the identical run — reuse the screen reading
            rec["full"] = dict(rec["screen"])
            return
    res = run(exp, cache=cache, device=device)
    throughput = _throughput_of(res)
    rec[stage] = {
        "throughput": throughput,
        "objective": _objective(spec, rec, throughput),
    }
    if res.avg_hops is not None:
        rec[stage]["avg_hops"] = float(res.avg_hops)
    if res.metric == "completion":
        rec[stage]["slots"] = res.slots
        rec[stage]["completed"] = res.completed


def _promote(spec: SearchSpec, screened: list) -> tuple:
    """Pick the screened candidates that re-run with the full window.

    Scalar top-``survivors`` halving alone would discard exactly the
    points the Pareto layer exists for: a cheap family can lose every
    objective comparison yet still be non-dominated on (throughput,
    cost).  So the screen-stage frontier (zero-throughput points
    excluded — a failed run earns no promotion) is always promoted, and
    the ``ceil(survivors * n)`` quota is then filled by objective rank.
    """
    ranked = sorted(screened, key=lambda r: r["screen"]["objective"],
                    reverse=True)
    n_promote = math.ceil(spec.survivors * len(ranked))
    pts = [{"throughput": r["screen"]["throughput"],
            "cost_links": r["cost_links"]} for r in ranked]
    promoted = [r for r, dom in zip(ranked, dominated_flags(pts))
                if not dom and r["screen"]["throughput"] > 0]
    chosen = {id(r) for r in promoted}
    for r in ranked:
        if len(promoted) >= n_promote:
            break
        if id(r) not in chosen:
            promoted.append(r)
            chosen.add(id(r))
    # keep run order deterministic: objective rank, frontier or not
    promoted.sort(key=lambda r: ranked.index(r))
    demoted = [r for r in ranked if id(r) not in chosen]
    return promoted, demoted


# ---------------------------------------------------------------------- #
# the loop
# ---------------------------------------------------------------------- #
def search(spec: SearchSpec, *, cache: Optional[SimulatorCache] = None,
           device=None) -> dict:
    """Run one design-space search on ``device`` (the card by default);
    returns the frontier record."""
    kind = check_pattern(spec.workload.pattern)
    if kind == "collective" and spec.workload.pattern != "all2all":
        raise ValueError(
            "search ranks candidates by delivered throughput; collective "
            "workloads other than all2all have no per-slot throughput "
            f"reading (got {spec.workload.pattern!r})")

    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    axes = axis_values(spec)
    budget = min(spec.budget, space_size(spec))
    seen: set = set()
    records: list = []

    owns = cache is None
    if owns:
        cache = SimulatorCache()

    def admit_and_screen(cand: Candidate) -> dict:
        seen.add(cand)
        rec = _price(spec, cand, len(records), device=dev)
        if rec["status"] == "admitted":
            _evaluate(spec, rec, cache, "screen", dev)
            rec["status"] = "screened"
        records.append(rec)
        return rec

    try:
        if spec.strategy == "random":
            while len(records) < budget:
                cand = _distinct(rng, axes, seen, lambda: _draw(rng, axes))
                if cand is None:
                    break
                admit_and_screen(cand)
        else:  # evolutionary
            n_seed = max(2, math.ceil(budget / 2))
            while len(records) < min(n_seed, budget):
                cand = _distinct(rng, axes, seen, lambda: _draw(rng, axes))
                if cand is None:
                    break
                admit_and_screen(cand)
            while len(records) < budget:
                pool = sorted(
                    (r for r in records if r["status"] == "screened"),
                    key=lambda r: r["screen"]["objective"], reverse=True)
                elites = pool[:max(1, len(pool) // 2)]
                if elites:
                    parent = Candidate.from_dict(
                        elites[rng.integers(0, len(elites))])
                    cand = _distinct(rng, axes, seen,
                                     lambda: _mutate(rng, axes, parent))
                else:
                    cand = _distinct(rng, axes, seen,
                                     lambda: _draw(rng, axes))
                if cand is None:
                    break
                admit_and_screen(cand)

        # ---- successive-halving promotion ---------------------------- #
        screened = [r for r in records if r["status"] == "screened"]
        promoted, demoted = _promote(spec, screened)
        # screened-out fabrics are done — drop their simulators before
        # the full-window runs so at most |promoted| stay live
        for rec in demoted:
            exp = rec["_exp"]
            cache.release(exp.network, exp.route, dev)
        for rec in promoted:
            _evaluate(spec, rec, cache, "full", dev)
            rec["status"] = "full"
            exp = rec["_exp"]
            cache.release(exp.network, exp.route, dev)
    finally:
        if owns:
            cache.close()

    for rec in records:
        rec.pop("_exp", None)
        if rec["status"] == "full":
            rec["throughput"] = rec["full"]["throughput"]
            rec["objective"] = rec["full"]["objective"]

    evaluated = [r for r in records if r["status"] == "full"]
    # a wedged network (zero delivered throughput over the full window)
    # earns no frontier spot, mirroring the promotion rule — it is
    # dominated outright, however cheap its links are
    alive = [r for r in evaluated if r["throughput"] > 0]
    for rec in evaluated:
        rec["dominated"] = True
    for rec, dom in zip(alive, dominated_flags(alive)):
        rec["dominated"] = dom
    frontier = frontier_ids(alive, [r["id"] for r in alive])

    counts = {s: sum(1 for r in records if r["status"] == s)
              for s in ("invalid", "pruned", "screened", "full")}
    return {
        "name": spec.label(),
        "spec": spec.to_dict(),
        "objective": spec.objective,
        "strategy": spec.strategy,
        "space_size": space_size(spec),
        "n_candidates": len(records),
        "counts": counts,
        "candidates": records,
        "frontier": frontier,
    }


def search_many(specs, *, device=None) -> list:
    """Run several searches; returns one record per spec."""
    return [search(s, device=device) for s in specs]
