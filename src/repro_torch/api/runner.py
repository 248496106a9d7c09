"""One-call experiment execution: ``run(experiment) -> Result``.

Topology -> ``build_tables`` -> ``Simulator`` -> measurement run, on the
card by default (the routing tables' distances too).  The port runs one
replica of the ``throughput`` and ``latency`` metrics of the Bernoulli
families the engine runs and the ``completion`` metric of a
free-running ``all2all``; scheduled collectives, the other metrics,
replicas and simulator caching come later.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Optional, Tuple

from .._device import resolve_device
from ..core.routing import build_tables
from ..simulator.engine import Simulator, Traffic
from ..workloads.patterns import check_pattern
from .registry import build_network
from .specs import Experiment

__all__ = ["Result", "run"]

# Result latency labels -> engine percentile keys
_LATENCY_KEYS = (("p50", "p0.5"), ("p99", "p0.99"), ("p999", "p0.999"),
                 ("p9999", "p0.9999"))


@dataclasses.dataclass(frozen=True)
class Result:
    """Structured record of one experiment run, field for field the
    reference's ``repro.api.runner.Result``.  Only the fields relevant to
    ``metric`` are populated; the rest stay ``None``.  ``latency`` maps
    ``p50``/``p99``/``p999``/``p9999`` to slots (``None`` when the window
    ejected nothing)."""

    experiment: Experiment
    metric: str
    throughput: Optional[float] = None
    avg_hops: Optional[float] = None
    ejected: Optional[float] = None
    pool_stall: Optional[float] = None
    offered: Optional[float] = None
    dropped: Optional[float] = None
    fail_drop: Optional[float] = None
    latency: Optional[Mapping[str, float]] = None
    slots: Optional[float] = None
    completed: Optional[bool] = None
    phase_slots: Optional[Tuple[float, ...]] = None
    replica_seeds: Optional[Tuple[int, ...]] = None
    per_replica: Optional[Mapping[str, Tuple]] = None
    aggregates: Optional[Mapping[str, Mapping[str, float]]] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["experiment"] = self.experiment.to_dict()
        if self.latency is not None:
            d["latency"] = dict(self.latency)
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


def _nan_none(v) -> Optional[float]:
    v = float(v)
    return None if math.isnan(v) else v


def run(experiment: Experiment, *, device=None) -> Result:
    """Execute ``experiment`` end to end and return a :class:`Result`.

    ``device=None`` runs on the card and raises if there is none; pass
    ``device="cpu"`` to run the kernels' plain versions on the host.
    """
    dev = resolve_device(device)
    metric = experiment.resolved_metric()
    w = experiment.workload
    if metric not in ("throughput", "latency", "completion"):
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet: the port runs "
            "'throughput', 'latency' and 'completion'")
    # the reference runs a scheduled all2all and the other collectives as
    # workload programs
    if check_pattern(w.pattern) == "collective" and (
            w.pattern != "all2all" or w.schedule):
        raise NotImplementedError(
            f"collective {w.pattern!r} (schedule {w.schedule!r}) runs as a "
            "workload program, which is not ported yet: the port runs the "
            "free-running all2all; workload programs come later")
    if metric == "completion" and w.pattern != "all2all":
        raise ValueError(f"completion metric needs a collective workload, "
                         f"got {w.pattern!r}")
    if experiment.replicas != 1:
        raise NotImplementedError("replicated runs are not ported yet")
    traffic = Traffic(pattern=w.pattern, load=w.load, rounds=w.rounds,
                      elephant_frac=w.elephant_frac,
                      elephant_size=w.elephant_size)
    tables = build_tables(build_network(experiment.network), device=dev)
    sim = Simulator(tables, experiment.route.to_sim_config(), device=dev)
    if metric == "completion":
        r = sim.run_completion(traffic, expected=sim.S * w.rounds,
                               chunk=experiment.chunk,
                               max_slots=experiment.max_slots,
                               seed=experiment.seed)
        return Result(experiment=experiment, metric=metric,
                      slots=int(r["slots"]), completed=bool(r["completed"]),
                      pool_stall=int(r["pool_stall"]))
    if metric == "throughput":
        r = sim.run_throughput(traffic, warm=experiment.warm,
                               measure=experiment.measure,
                               seed=experiment.seed)
        return Result(experiment=experiment, metric=metric,
                      throughput=float(r["throughput"]),
                      avg_hops=float(r["avg_hops"]),
                      ejected=int(r["ejected"]),
                      pool_stall=int(r["pool_stall"]))
    r = sim.run_latency(traffic, warm=experiment.warm,
                        measure=experiment.measure, seed=experiment.seed)
    lat = {lbl: _nan_none(r[k]) for lbl, k in _LATENCY_KEYS}
    return Result(experiment=experiment, metric=metric, latency=lat)
