"""Experiment execution: ``run(experiment) -> Result`` and
``run_all(experiments) -> [Result]``.

Topology -> ``build_tables`` -> ``Simulator`` -> measurement run, on the
card by default (the routing tables' distances too).  A
:class:`SimulatorCache` keeps one simulator (tables, masks and the
static index tables) per fabric, routing and device, so the experiments
of one fabric share its set-up.  The port runs one replica of the
``throughput`` and ``latency`` metrics of the Bernoulli families the
engine runs and the ``completion`` metric of a free-running
``all2all``; scheduled collectives, the other metrics and replicas come
later.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from typing import Mapping, Optional, Tuple

import torch

from .._device import resolve_device
from ..core.routing import build_tables
from ..simulator.engine import Simulator, Traffic
from ..workloads.patterns import check_pattern
from .registry import build_network
from .specs import Experiment, NetworkSpec, RouteSpec

__all__ = ["Result", "SimulatorCache", "open_simulator", "run", "run_all"]

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

    @property
    def name(self) -> str:
        return self.experiment.label()

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


# ---------------------------------------------------------------------- #
# simulator lifetime
# ---------------------------------------------------------------------- #
def _make_simulator(network: NetworkSpec, route: RouteSpec,
                    device: torch.device) -> Simulator:
    tables = build_tables(build_network(network), device=device)
    return Simulator(tables, route.to_sim_config(), device=device)


class SimulatorCache:
    """Simulator reuse across experiments.

    Keyed on ``(NetworkSpec, RouteSpec, device)``, so the experiments of
    one fabric (loads, patterns, seeds) build its topology, tables and
    device masks once.  Also a context manager: closing drops every
    cached simulator and, where one was on the card, returns the freed
    blocks of PyTorch's caching allocator to the card.
    """

    def __init__(self):
        self._sims: dict = {}

    def get(self, network: NetworkSpec, route: RouteSpec,
            device=None) -> Simulator:
        """The simulator of ``(network, route)`` on ``device`` (the card
        by default), built on first use."""
        dev = resolve_device(device)
        key = (network, route, dev)
        sim = self._sims.get(key)
        if sim is None:
            sim = self._sims[key] = _make_simulator(network, route, dev)
        return sim

    def __len__(self) -> int:
        return len(self._sims)

    def release(self, network: NetworkSpec, route: RouteSpec,
                device=None) -> None:
        """Drop one simulator (no-op if absent), for callers that know a
        fabric is not needed again before the cache as a whole closes."""
        self._sims.pop((network, route, resolve_device(device)), None)

    def close(self) -> None:
        keys, self._sims = list(self._sims), {}
        if any(dev.type == "cuda" for _, _, dev in keys):
            torch.cuda.empty_cache()

    def __enter__(self) -> "SimulatorCache":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


@contextlib.contextmanager
def open_simulator(network: NetworkSpec, route: RouteSpec = RouteSpec(), *,
                   device=None):
    """A context-managed Simulator for a spec pair."""
    with SimulatorCache() as cache:
        yield cache.get(network, route, device)


# ---------------------------------------------------------------------- #
# execution
# ---------------------------------------------------------------------- #
def _to_traffic(exp: Experiment) -> Traffic:
    w = exp.workload
    return Traffic(pattern=w.pattern, load=w.load, rounds=w.rounds,
                   elephant_frac=w.elephant_frac,
                   elephant_size=w.elephant_size,
                   shift=w.shift, hot_frac=w.hot_frac,
                   hot_count=w.hot_count, burst_len=w.burst_len,
                   burst_load=w.burst_load)


def _check_runnable(experiment: Experiment) -> str:
    """Refuse what the port does not run yet, before anything is built;
    returns the metric."""
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
    return metric


def run(experiment: Experiment, *, cache: Optional[SimulatorCache] = None,
        device=None) -> Result:
    """Execute ``experiment`` end to end and return a :class:`Result`.

    ``device=None`` runs on the card and raises if there is none; pass
    ``device="cpu"`` to run the kernels' plain versions on the host.
    With ``cache`` given, the simulator is taken from it (built there on
    first use) and left in it; otherwise a private one is built.
    """
    dev = resolve_device(device)
    metric = _check_runnable(experiment)
    sim = (_make_simulator(experiment.network, experiment.route, dev)
           if cache is None
           else cache.get(experiment.network, experiment.route, dev))
    return _run_on(sim, experiment, metric)


def run_all(experiments, *, cache: Optional[SimulatorCache] = None,
            fold_seeds: bool = True, device=None) -> list:
    """Run a sequence of experiments, sharing one simulator among the
    entries of a fabric.  With a private cache (none passed in), each
    fabric's simulator is dropped right after its last use.

    The reference folds consecutive experiments that differ only in
    ``seed`` into one batched run when ``fold_seeds`` is set; until
    replicas are ported, the port runs such a group seed by seed.  The
    Results are the same either way (the reference's replica ``i`` is
    bitwise its scalar run with seed ``i``), so ``fold_seeds`` changes
    nothing here.  Every experiment is checked before anything is built.
    """
    experiments = list(experiments)
    dev = resolve_device(device)
    for e in experiments:
        _check_runnable(e)
    owns = cache is None
    if owns:
        cache = SimulatorCache()
    last_use = {(e.network, e.route): i for i, e in enumerate(experiments)}
    try:
        results = []
        for i, e in enumerate(experiments):
            results.append(run(e, cache=cache, device=dev))
            if owns and last_use[(e.network, e.route)] == i:
                cache.release(e.network, e.route, dev)
        return results
    finally:
        if owns:
            cache.close()


def _run_on(sim: Simulator, experiment: Experiment, metric: str) -> Result:
    w = experiment.workload
    traffic = _to_traffic(experiment)
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
