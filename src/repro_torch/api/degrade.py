"""Degraded-mode resilience sweeps: throughput retention against links
down, the port of the reference's ``repro.api.degrade``.

:func:`degrade_sweep` takes one frozen :class:`DegradeSpec` -- a base
:class:`Experiment` plus a ladder of link-failure *rates* (fractions of
the fabric's undirected links) -- runs the ``resilience`` metric at each
rate and folds the results into the reference's degradation record::

    {"name": ..., "base": {...}, "n_links": L, "policy": ...,
     "fail_policy": "requeue" | "drop", "down_slot": ..., "fail_seed": ...,
     "points": [{"rate", "n_links_down", "delivered", "avg_hops",
                 "fail_drop", "p50", "p99", "retention"}, ...]}

``retention`` is delivered throughput relative to the sweep's rate-0
point (``None`` when the sweep has no rate 0).  The failed links come
from :meth:`FailureSchedule.random_links` with one seed, so the 5 % set
holds the smaller sets and the curve follows the failed-link
population, not resampled noise.

All rates share one simulator, armed with the largest schedule: between
rates only its ``failures`` attribute changes, and ``run_resilience``
restores the pristine tables after every run.  A raw dict (the JSON
file format) is accepted through ``DegradeSpec.from_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

from .._device import resolve_device
from ..core.failures import FailureSchedule, canonical_link_ids
from ..core.routing import build_tables
from ..simulator.engine import Simulator
from .registry import build_network
from .runner import _to_traffic
from .specs import Experiment

__all__ = ["DegradeSpec", "degrade_sweep", "degrade_sweep_many"]

DEFAULT_RATES = (0.0, 0.01, 0.02, 0.05, 0.10)


@dataclasses.dataclass(frozen=True)
class DegradeSpec:
    """One degradation sweep: base experiment x failure-rate ladder.

    ``base`` supplies fabric, route (typically ``policy="degraded"``),
    workload, warm/measure window and seed; a failure schedule already on
    ``base.network`` is ignored (the sweep owns failure injection).
    ``fail_seed`` seeds the link ladder, ``down_slot`` is the failure
    slot, ``fail_policy`` what packets on a dead port do (``requeue`` |
    ``drop``).
    """

    base: Experiment
    rates: Tuple[float, ...] = DEFAULT_RATES
    down_slot: int = 1
    fail_policy: str = "requeue"
    fail_seed: int = 0

    def __post_init__(self):
        if not isinstance(self.base, Experiment):
            object.__setattr__(self, "base", Experiment.from_dict(self.base))
        rates = tuple(float(r) for r in self.rates)
        if not rates:
            raise ValueError("DegradeSpec needs at least one rate")
        if any(r < 0 or r >= 1 for r in rates):
            raise ValueError(f"rates must lie in [0, 1), got {list(rates)}")
        object.__setattr__(self, "rates", rates)
        if self.fail_policy not in ("requeue", "drop"):
            raise ValueError(f"unknown fail_policy {self.fail_policy!r} "
                             "(expected requeue|drop)")
        if self.down_slot < 0:
            raise ValueError(f"down_slot must be >= 0, got {self.down_slot}")

    def to_dict(self) -> dict:
        return {"base": self.base.to_dict(), "rates": list(self.rates),
                "down_slot": self.down_slot,
                "fail_policy": self.fail_policy,
                "fail_seed": self.fail_seed}

    @classmethod
    def from_dict(cls, d: Mapping) -> "DegradeSpec":
        return cls(base=Experiment.from_dict(d["base"]),
                   rates=tuple(d.get("rates", DEFAULT_RATES)),
                   down_slot=int(d.get("down_slot", 1)),
                   fail_policy=d.get("fail_policy", "requeue"),
                   fail_seed=int(d.get("fail_seed", 0)))


def _schedule(topo, k: int, *, down_slot: int, seed: int,
              fail_policy: str) -> FailureSchedule:
    if k == 0:
        return FailureSchedule(events=(), policy=fail_policy)
    return FailureSchedule.random_links(topo, k, down_slot=down_slot,
                                        seed=seed, policy=fail_policy)


def degrade_sweep(spec: Union[DegradeSpec, Mapping], *,
                  device=None) -> dict:
    """Run one degradation sweep on ``device`` (the card by default) and
    return its record (see the module docstring)."""
    if not isinstance(spec, DegradeSpec):
        spec = DegradeSpec.from_dict(spec)
    dev = resolve_device(device)
    base = spec.base
    network = dataclasses.replace(base.network, failures=None)
    topo = build_network(network)
    n_links = int(len(canonical_link_ids(topo)))
    ks = [int(round(r * n_links)) for r in spec.rates]
    schedules = [_schedule(topo, k, down_slot=spec.down_slot,
                           seed=spec.fail_seed,
                           fail_policy=spec.fail_policy) for k in ks]

    # arm the simulator with the largest schedule; each rate swaps in its
    # own (run_resilience restores the pristine tables after each run)
    arm = max(schedules, key=len)
    if len(arm) == 0:
        arm = _schedule(topo, 1, down_slot=spec.down_slot,
                        seed=spec.fail_seed, fail_policy=spec.fail_policy)
    sim = Simulator(build_tables(topo, device=dev),
                    base.route.to_sim_config(), arm, device=dev)
    traffic = _to_traffic(base)

    points = []
    for rate, k, sched in zip(spec.rates, ks, schedules):
        sim.failures = sched.validate(topo)
        r = sim.run_resilience(traffic, warm=base.warm,
                               measure=base.measure, seed=base.seed)
        points.append({
            "rate": rate, "n_links_down": k,
            "delivered": float(r["throughput"]),
            "avg_hops": float(r["avg_hops"]),
            "fail_drop": int(r["fail_drop"]),
            "p50": _none_nan(r["p0.5"]), "p99": _none_nan(r["p0.99"]),
        })

    base_pt = next((p for p in points if p["n_links_down"] == 0), None)
    for p in points:
        p["retention"] = (p["delivered"] / base_pt["delivered"]
                          if base_pt and base_pt["delivered"] else None)

    return {"name": base.label(), "base": base.to_dict(),
            "n_links": n_links, "policy": base.route.policy,
            "fail_policy": spec.fail_policy, "down_slot": spec.down_slot,
            "fail_seed": spec.fail_seed, "points": points}


def degrade_sweep_many(specs: Sequence[Union[DegradeSpec, Mapping]], *,
                       device=None) -> list:
    """Run several degradation sweeps; one record per spec."""
    return [degrade_sweep(s, device=device) for s in specs]


def _none_nan(v) -> Optional[float]:
    v = float(v)
    return None if v != v else v
