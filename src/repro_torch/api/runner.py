"""Experiment execution: ``run(experiment) -> Result`` and
``run_all(experiments) -> [Result]``.

Topology -> ``build_tables`` -> ``Simulator`` -> measurement run, on the
card by default (the routing tables' distances too).  A
:class:`SimulatorCache` keeps one simulator (tables, masks and the
static index tables) per fabric, routing and device, so the experiments
of one fabric share its set-up.  The port runs the ``throughput`` and
``latency`` metrics of the Bernoulli families and the ``completion``
metric of the collectives: the free-running ``all2all`` directly, every
other collective (a scheduled ``all2all``, the allreduce family,
anything added through ``register_program_builder``) as a compiled
workload program on the engine's phase scheduler.  An experiment with
``replicas`` > 1 runs its seeds as one batched run (one step for all
replicas), and its Result carries ``per_replica``, ``aggregates`` and
``replica_seeds`` beside the means; ``run_all`` folds consecutive
experiments that differ only in their seed into one such run.  The
arrival families (``poisson``, ``pareto``, ``diurnal``) run as the
engine's ``Traffic("arrival")`` under the ``serving`` metric: offered
and delivered load, source drops and the latency percentiles.  A
network with a failure schedule runs under the ``resilience`` metric
(``Simulator.run_resilience``): throughput, hops, drops and latency
while its links and switches go down and come back; its replicas run
one after the other, since each transition rewrites the shared tables.

Every entry prices its experiments before anything is built
(:mod:`repro_torch.api.admission`): one whose predicted peak exceeds its
device's budget is refused with an ``AdmissionError``
(``REPRO_ADMISSION=warn|off`` relaxes the gate).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core.routing import build_tables
from ..simulator.engine import Simulator, Traffic
from ..workloads import (PROGRAM_BUILDERS, build_collective_program,
                         compile_program)
from ..workloads.patterns import check_pattern
from .admission import check_admission, device_budget_bytes, device_bytes
from .registry import network_topology
from .specs import Experiment, NetworkSpec, RouteSpec

__all__ = ["Result", "SimulatorCache", "open_simulator", "run", "run_all"]

# Result latency labels -> engine percentile keys
_LATENCY_KEYS = (("p50", "p0.5"), ("p99", "p0.99"), ("p999", "p0.999"),
                 ("p9999", "p0.9999"))


def _retuple(v):
    """JSON arrays -> tuples, recursively (inverse of JSON serialization)."""
    if isinstance(v, (list, tuple)):
        return tuple(_retuple(x) for x in v)
    return v


def _aggregate(values) -> Optional[dict]:
    """mean/std/min/max over per-replica values (``None`` entries dropped;
    bools averaged as completion fractions)."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return None
    arr = np.asarray(vals, np.float64)
    return {"mean": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max())}


@dataclasses.dataclass(frozen=True)
class Result:
    """Structured record of one experiment run, field for field the
    reference's ``repro.api.runner.Result``, and serialised as it is.
    Only the fields relevant to ``metric`` are populated; the rest stay
    ``None``.  ``latency`` maps ``p50``/``p99``/``p999``/``p9999`` to
    slots (``None`` when the window ejected nothing); ``phase_slots``
    holds the per-phase completion slots of a workload program.

    For a batched run (``experiment.replicas > 1``) the scalar metric
    fields hold the across-replica *mean* (``completed`` is the AND), and
    three extra fields are populated: ``replica_seeds`` (the seeds, in
    replica order), ``per_replica`` (field name -> tuple of exact
    per-replica values) and ``aggregates`` (field name ->
    ``{"mean","std","min","max"}``)."""

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
        if self.phase_slots is not None:
            d["phase_slots"] = list(self.phase_slots)
        if self.replica_seeds is not None:
            d["replica_seeds"] = list(self.replica_seeds)
        if self.per_replica is not None:
            d["per_replica"] = {k: list(v) for k, v in self.per_replica.items()}
        if self.aggregates is not None:
            d["aggregates"] = {k: dict(v) for k, v in self.aggregates.items()}
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "Result":
        d = dict(d)
        d["experiment"] = Experiment.from_dict(d["experiment"])
        for key in ("phase_slots", "replica_seeds"):
            if d.get(key) is not None:
                d[key] = _retuple(d[key])
        if d.get("per_replica") is not None:
            d["per_replica"] = {k: _retuple(v)
                                for k, v in d["per_replica"].items()}
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Result":
        return cls.from_dict(json.loads(s))


def _nan_none(v) -> Optional[float]:
    v = float(v)
    return None if math.isnan(v) else v


# ---------------------------------------------------------------------- #
# simulator lifetime
# ---------------------------------------------------------------------- #
def _make_simulator(network: NetworkSpec, route: RouteSpec,
                    device: torch.device) -> Simulator:
    topo = network_topology(network)     # the admission gate's build
    if network.failures is not None:
        network.failures.validate(topo)   # fail before the table build
    tables = build_tables(topo, device=device)
    return Simulator(tables, route.to_sim_config(), network.failures,
                     device=device)


class SimulatorCache:
    """Simulator reuse across experiments.

    Keyed on ``(NetworkSpec, RouteSpec, device)``, so the experiments of
    one fabric (loads, patterns, seeds) build its topology, tables and
    device masks once (a failure schedule is part of the
    ``NetworkSpec``, so a degraded fabric never shares its pristine
    twin's simulator).  Also a context manager: closing drops every
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

    def holds(self, network: NetworkSpec, route: RouteSpec,
              device=None) -> bool:
        """Whether the simulator of ``(network, route)`` on ``device`` is
        built."""
        return (network, route, resolve_device(device)) in self._sims

    def release(self, network: NetworkSpec, route: RouteSpec,
                device=None) -> None:
        """Drop one simulator (no-op if absent), for callers that know a
        fabric is not needed again before the cache as a whole closes."""
        self._sims.pop((network, route, resolve_device(device)), None)

    def close(self) -> None:
        sims, self._sims = self._sims, {}
        for sim in sims.values():
            sim.close()
        if any(dev.type == "cuda" for _, _, dev in sims):
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
    if check_pattern(w.pattern) == "arrival":
        # an arrival family reaches the engine as Traffic("arrival") with
        # the family in ``process``
        return Traffic("arrival", process=w.pattern, load=w.load,
                       pareto_alpha=w.pareto_alpha,
                       pareto_cap=w.pareto_cap,
                       diurnal_amp=w.diurnal_amp,
                       diurnal_period=w.diurnal_period,
                       arr_depth=w.arr_depth)
    return Traffic(pattern=w.pattern, load=w.load, rounds=w.rounds,
                   elephant_frac=w.elephant_frac,
                   elephant_size=w.elephant_size,
                   shift=w.shift, hot_frac=w.hot_frac,
                   hot_count=w.hot_count, burst_len=w.burst_len,
                   burst_load=w.burst_load)


def _is_program(exp: Experiment) -> bool:
    """Collectives with a program builder run as workload programs.
    ``all2all`` only joins when a schedule is requested (its default is
    the free-running engine pattern); everything else in
    ``PROGRAM_BUILDERS`` — built-in or registered through
    ``register_program_builder`` — always compiles."""
    w = exp.workload
    if w.pattern == "all2all":
        return bool(w.schedule)
    return w.pattern in PROGRAM_BUILDERS


def _check_runnable(experiment: Experiment) -> str:
    """Refuse, before anything is built, what cannot run (the
    reference's errors, with its messages); returns the metric."""
    metric = experiment.resolved_metric()
    w = experiment.workload
    program = _is_program(experiment)
    # a program with another metric raises the reference's ValueError
    if program and metric != "completion":
        raise ValueError(f"{w.pattern} only supports the completion "
                         "metric")
    failures = experiment.network.failures
    if metric == "resilience" and (failures is None or not len(failures)):
        raise ValueError(
            "run_resilience needs a Simulator built with a non-empty "
            "FailureSchedule (failures=...); use run_throughput for "
            "pristine fabrics")
    if metric == "completion" and not program and w.pattern != "all2all":
        raise ValueError(f"completion metric needs a collective workload, "
                         f"got {w.pattern!r}")
    return metric


def _admit(experiment: Experiment, cache: Optional[SimulatorCache],
           dev: torch.device):
    """The admission gate: price ``experiment`` against ``dev``'s budget
    before anything is built.  A simulator the cache already holds is
    part of the price, so its bytes count as budget."""
    budget = device_budget_bytes(dev)
    if (budget is not None and cache is not None
            and cache.holds(experiment.network, experiment.route, dev)):
        budget += device_bytes(experiment, dev)["simulator_bytes"]
    return check_admission(experiment, budget_bytes=budget, device=dev)


def run(experiment: Experiment, *, cache: Optional[SimulatorCache] = None,
        device=None) -> Result:
    """Execute ``experiment`` end to end and return a :class:`Result`.

    ``device=None`` runs on the card and raises if there is none; pass
    ``device="cpu"`` to run the kernels' plain versions on the host.
    With ``cache`` given, the simulator is taken from it (built there on
    first use) and left in it; otherwise a private one is built.

    Admission control runs first: an experiment whose predicted peak
    (:func:`repro_torch.api.admission.device_peak_bytes`) exceeds the
    device's budget raises ``AdmissionError`` before anything is built.
    """
    dev = resolve_device(device)
    metric = _check_runnable(experiment)
    _admit(experiment, cache, dev)
    sim = (_make_simulator(experiment.network, experiment.route, dev)
           if cache is None
           else cache.get(experiment.network, experiment.route, dev))
    return _run_on(sim, experiment, metric)


def run_all(experiments, *, cache: Optional[SimulatorCache] = None,
            fold_seeds: bool = True, device=None) -> list:
    """Run a sequence of experiments, sharing one simulator among the
    entries of a fabric.  With a private cache (none passed in), each
    fabric's simulator is dropped right after its last use.

    ``fold_seeds=True`` (default) folds consecutive experiments that
    differ only in ``seed`` (e.g. a ``sweep`` seed axis) into one
    batched run, then splits the Results back out: the same Results
    (replica ``i`` is bitwise the scalar run of the group's ``i``-th
    experiment), in one run.  Every experiment is checked before
    anything is built, and priced by the admission gate.
    """
    experiments = list(experiments)
    dev = resolve_device(device)
    for e in experiments:
        _check_runnable(e)
    groups = (_fold_groups(experiments) if fold_seeds
              else [[e] for e in experiments])
    # a folded group runs as one batch of len(group) replicas
    for group in groups:
        _admit(group[0] if len(group) == 1
               else dataclasses.replace(group[0], replicas=len(group)),
               cache, dev)
    owns = cache is None
    if owns:
        cache = SimulatorCache()
    last_use = {(e.network, e.route): i for i, e in enumerate(experiments)}
    results = []
    pos = 0
    try:
        for group in groups:
            if len(group) == 1:
                results.append(run(group[0], cache=cache, device=dev))
            else:
                sim = cache.get(group[0].network, group[0].route, dev)
                metric, per = _batched_metrics(sim, group[0],
                                               [e.seed for e in group])
                results.extend(_unfold_batch(group, metric, per))
            pos += len(group)
            e = group[-1]
            if owns and last_use[(e.network, e.route)] == pos - 1:
                cache.release(e.network, e.route, dev)
        return results
    finally:
        if owns:
            cache.close()


def _collective_program(sim: Simulator, exp: Experiment):
    """Build and compile the workload program of a collective experiment:
    the allreduce family defaults to the ``barrier`` schedule (bitwise
    the host loop), a scheduled ``all2all`` compiles its rounds under
    the requested mode."""
    w = exp.workload
    prog = build_collective_program(
        w.pattern, sim.S, rounds=w.rounds, ranks=w.ranks,
        vec_packets=w.vec_packets)
    return compile_program(prog, schedule=w.schedule or "barrier",
                           window=w.window)


def _run_collective(sim: Simulator, exp: Experiment) -> Result:
    """One program run on the phase scheduler: every phase, one host sync
    a chunk."""
    cp = _collective_program(sim, exp)
    r = sim.run_program(cp, chunk=exp.chunk, max_slots=exp.max_slots,
                        seed=exp.seed)
    return Result(experiment=exp, metric="completion",
                  slots=int(r["slots"]), completed=bool(r["completed"]),
                  pool_stall=int(r["pool_stall"]),
                  phase_slots=tuple(int(s) for s in r["phase_slots"]))


# ---------------------------------------------------------------------- #
# batched execution: one step for all replicas
# ---------------------------------------------------------------------- #
def _batched_metrics(sim: Simulator, exp: Experiment, seeds) -> Tuple[str,
                                                                       dict]:
    """Run ``exp`` once per seed in one batched run.

    Returns ``(metric, per)`` where ``per`` maps metric field names to
    tuples of exact per-replica Python scalars (``phase_slots``: a tuple
    of per-replica tuples).  Replica ``i`` is bitwise the scalar run with
    ``seed=seeds[i]``.
    """
    metric = exp.resolved_metric()
    w = exp.workload
    seeds = [int(s) for s in seeds]
    if _is_program(exp):
        # all R replicas x P phases on the phase scheduler
        cp = _collective_program(sim, exp)
        r = sim.run_program(cp, chunk=exp.chunk, max_slots=exp.max_slots,
                            seeds=seeds)
        return metric, {
            "slots": tuple(int(x) for x in r["slots"]),
            "completed": tuple(bool(x) for x in r["completed"]),
            "pool_stall": tuple(int(x) for x in r["pool_stall"]),
            "phase_slots": tuple(tuple(int(v) for v in row)
                                 for row in r["phase_slots"]),
        }
    traffic = _to_traffic(exp)
    if metric == "throughput":
        r = sim.run_throughput_batch(traffic, seeds, warm=exp.warm,
                                     measure=exp.measure)
        return metric, {
            "throughput": tuple(float(x) for x in r["throughput"]),
            "avg_hops": tuple(float(x) for x in r["avg_hops"]),
            "ejected": tuple(int(x) for x in r["ejected"]),
            "pool_stall": tuple(int(x) for x in r["pool_stall"]),
        }
    if metric == "latency":
        r = sim.run_latency_batch(traffic, seeds, warm=exp.warm,
                                  measure=exp.measure)
        return metric, {lbl: tuple(_nan_none(v) for v in r[k])
                        for lbl, k in _LATENCY_KEYS}
    if metric == "serving":
        r = sim.run_serving_batch(traffic, seeds, warm=exp.warm,
                                  measure=exp.measure)
        per = {
            "throughput": tuple(float(x) for x in r["delivered"]),
            "offered": tuple(float(x) for x in r["offered"]),
            "dropped": tuple(int(x) for x in r["dropped"]),
            "pool_stall": tuple(int(x) for x in r["pool_stall"]),
        }
        per.update({lbl: tuple(_nan_none(v) for v in r[k])
                    for lbl, k in _LATENCY_KEYS})
        return metric, per
    if metric == "resilience":
        # each transition rewrites the simulator's tables, so the
        # replicas run one after the other (replica i is the scalar run
        # of seeds[i], as in the reference)
        runs = [sim.run_resilience(traffic, warm=exp.warm,
                                   measure=exp.measure, seed=s)
                for s in seeds]
        per = {"throughput": tuple(float(r["throughput"]) for r in runs),
               "avg_hops": tuple(float(r["avg_hops"]) for r in runs),
               "ejected": tuple(int(r["ejected"]) for r in runs),
               "pool_stall": tuple(int(r["pool_stall"]) for r in runs),
               "fail_drop": tuple(int(r["fail_drop"]) for r in runs)}
        per.update({lbl: tuple(_nan_none(r[k]) for r in runs)
                    for lbl, k in _LATENCY_KEYS})
        return metric, per
    # completion of the free-running all2all (_check_runnable let no
    # other metric through)
    r = sim.run_completion_batch(traffic, expected=sim.S * w.rounds,
                                 seeds=seeds, chunk=exp.chunk,
                                 max_slots=exp.max_slots)
    return metric, {
        "slots": tuple(int(x) for x in r["slots"]),
        "completed": tuple(bool(x) for x in r["completed"]),
        "pool_stall": tuple(int(x) for x in r["pool_stall"]),
    }


def _batched_result(exp: Experiment, seeds, metric: str, per: dict) -> Result:
    """The Result of a batched run: the means in the metric fields,
    ``per_replica``, ``aggregates`` and ``replica_seeds``."""
    agg = {}
    for k, vals in per.items():
        if k == "phase_slots":
            continue
        a = _aggregate(vals)
        if a is not None:
            agg[k] = a

    def mean(k):
        return agg[k]["mean"] if k in agg else None

    if metric == "throughput":
        kw = dict(throughput=mean("throughput"), avg_hops=mean("avg_hops"),
                  ejected=mean("ejected"), pool_stall=mean("pool_stall"))
    elif metric == "latency":
        kw = dict(latency={lbl: mean(lbl) for lbl, _ in _LATENCY_KEYS})
    elif metric == "serving":
        kw = dict(throughput=mean("throughput"), offered=mean("offered"),
                  dropped=mean("dropped"), pool_stall=mean("pool_stall"),
                  latency={lbl: mean(lbl) for lbl, _ in _LATENCY_KEYS})
    elif metric == "resilience":
        kw = dict(throughput=mean("throughput"), avg_hops=mean("avg_hops"),
                  ejected=mean("ejected"), pool_stall=mean("pool_stall"),
                  fail_drop=mean("fail_drop"),
                  latency={lbl: mean(lbl) for lbl, _ in _LATENCY_KEYS})
    else:
        kw = dict(slots=mean("slots"),
                  completed=bool(all(per["completed"])),
                  pool_stall=mean("pool_stall"))
        if "phase_slots" in per:
            rows = per["phase_slots"]
            kw["phase_slots"] = tuple(
                float(np.mean([row[i] for row in rows]))
                for i in range(len(rows[0])))
    return Result(experiment=exp, metric=metric,
                  replica_seeds=tuple(int(s) for s in seeds),
                  per_replica=per, aggregates=agg, **kw)


def _unfold_batch(group, metric: str, per: dict) -> list:
    """Split one batched run back into per-experiment scalar Results (the
    folded seed-only group of ``run_all``: replica ``i`` is bitwise the
    scalar run of ``group[i]``, so the Results are interchangeable)."""
    out = []
    for i, e in enumerate(group):
        if metric == "throughput":
            kw = dict(throughput=per["throughput"][i],
                      avg_hops=per["avg_hops"][i],
                      ejected=per["ejected"][i],
                      pool_stall=per["pool_stall"][i])
        elif metric == "latency":
            kw = dict(latency={lbl: per[lbl][i]
                               for lbl, _ in _LATENCY_KEYS})
        elif metric == "serving":
            kw = dict(throughput=per["throughput"][i],
                      offered=per["offered"][i],
                      dropped=per["dropped"][i],
                      pool_stall=per["pool_stall"][i],
                      latency={lbl: per[lbl][i]
                               for lbl, _ in _LATENCY_KEYS})
        elif metric == "resilience":
            kw = dict(throughput=per["throughput"][i],
                      avg_hops=per["avg_hops"][i],
                      ejected=per["ejected"][i],
                      pool_stall=per["pool_stall"][i],
                      fail_drop=per["fail_drop"][i],
                      latency={lbl: per[lbl][i]
                               for lbl, _ in _LATENCY_KEYS})
        else:
            kw = dict(slots=per["slots"][i], completed=per["completed"][i],
                      pool_stall=per["pool_stall"][i])
            if "phase_slots" in per:
                kw["phase_slots"] = per["phase_slots"][i]
        out.append(Result(experiment=e, metric=metric, **kw))
    return out


def _fold_key(e: Experiment) -> Experiment:
    return dataclasses.replace(e, seed=0, name="")


def _fold_groups(experiments) -> list:
    """Group consecutive experiments that differ only in ``seed``/``name``
    (unbatched ones): each group becomes one batched run."""
    groups = []
    for e in experiments:
        if (groups and e.replicas == 1 and groups[-1][0].replicas == 1
                and _fold_key(groups[-1][0]) == _fold_key(e)):
            groups[-1].append(e)
        else:
            groups.append([e])
    return groups


def _run_on(sim: Simulator, experiment: Experiment, metric: str) -> Result:
    w = experiment.workload
    if experiment.replicas > 1:
        seeds = experiment.replica_seeds()
        metric, per = _batched_metrics(sim, experiment, seeds)
        return _batched_result(experiment, seeds, metric, per)
    if _is_program(experiment):
        return _run_collective(sim, experiment)
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
    if metric == "serving":
        r = sim.run_serving(traffic, warm=experiment.warm,
                            measure=experiment.measure, seed=experiment.seed)
        lat = {lbl: _nan_none(r[k]) for lbl, k in _LATENCY_KEYS}
        return Result(experiment=experiment, metric=metric,
                      throughput=float(r["delivered"]),
                      offered=float(r["offered"]),
                      dropped=int(r["dropped"]),
                      pool_stall=int(r["pool_stall"]), latency=lat)
    if metric == "resilience":
        r = sim.run_resilience(traffic, warm=experiment.warm,
                               measure=experiment.measure,
                               seed=experiment.seed)
        lat = {lbl: _nan_none(r[k]) for lbl, k in _LATENCY_KEYS}
        return Result(experiment=experiment, metric=metric,
                      throughput=float(r["throughput"]),
                      avg_hops=float(r["avg_hops"]),
                      ejected=int(r["ejected"]),
                      pool_stall=int(r["pool_stall"]),
                      fail_drop=int(r["fail_drop"]), latency=lat)
    r = sim.run_latency(traffic, warm=experiment.warm,
                        measure=experiment.measure, seed=experiment.seed)
    lat = {lbl: _nan_none(r[k]) for lbl, k in _LATENCY_KEYS}
    return Result(experiment=experiment, metric=metric, latency=lat)
