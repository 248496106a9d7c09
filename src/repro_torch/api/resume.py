"""Experiment-level resumable runs: ``run_resumable`` / ``resume``.

The glue between the declarative layer and
:mod:`repro_torch.runtime.resilient`: ``run_resumable(experiment,
ckpt_dir)`` runs an experiment through the checkpointed segment runs
and writes, as the reference does,

* ``<ckpt_dir>/experiment.json``: the spec, once, at the start (so a bare
  directory is resumable with no other context);
* ``<ckpt_dir>/step_*/``: the engine-state snapshots (atomic, bounded
  retention, :class:`repro_torch.checkpointing.Checkpointer`);
* ``<ckpt_dir>/result.json``: the final :class:`Result`, at the end.

Calling it again on the same directory, after a crash, a SIGKILL or an
OOM kill, picks up the latest intact snapshot and gives a Result bitwise
the uninterrupted run's.  ``resume(ckpt_dir)`` is the variant driven by
the stored spec alone (the CLI's ``resume``).

Metrics: ``completion`` (workload programs and the free-running
all2all), ``throughput``, ``latency`` and ``serving``, of one replica or
several.  ``resilience`` runs apply failure transitions from the host at
exact slots in the middle of a run; they are refused, as in the
reference.  The simulator is built as :func:`repro_torch.api.run` builds
it; the reference's admission gate comes with the port's memory model
(ROADMAP item 10).
"""
from __future__ import annotations

import os
from typing import Optional

from .._device import resolve_device
from ..runtime.resilient import (ResilientConfig, run_completion_resumable,
                                 run_program_resumable, run_window_resumable)
from .runner import (Result, SimulatorCache, _LATENCY_KEYS, _batched_result,
                     _check_runnable, _collective_program, _is_program,
                     _make_simulator, _nan_none, _to_traffic)
from .specs import Experiment

__all__ = ["run_resumable", "resume"]


def _write_spec(ckpt_dir: str, experiment: Experiment) -> None:
    path = os.path.join(ckpt_dir, "experiment.json")
    if os.path.exists(path):
        with open(path) as f:
            stored = Experiment.from_json(f.read())
        if stored != experiment:
            raise ValueError(
                f"{path} holds a different experiment "
                f"({stored.label()!r} != {experiment.label()!r}); refusing "
                "to mix checkpoints.  Use a fresh --ckpt-dir.")
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(experiment.to_json(indent=1))
    os.replace(tmp, path)


def _scalar_window_result(exp: Experiment, metric: str, r: dict) -> Result:
    if metric == "throughput":
        return Result(experiment=exp, metric=metric,
                      throughput=float(r["throughput"]),
                      avg_hops=float(r["avg_hops"]),
                      ejected=int(r["ejected"]),
                      pool_stall=int(r["pool_stall"]))
    lat = {lbl: _nan_none(r[k]) for lbl, k in _LATENCY_KEYS}
    if metric == "latency":
        return Result(experiment=exp, metric=metric, latency=lat)
    return Result(experiment=exp, metric=metric,
                  throughput=float(r["delivered"]),
                  offered=float(r["offered"]),
                  dropped=int(r["dropped"]),
                  pool_stall=int(r["pool_stall"]), latency=lat)


def _batched_window_per(metric: str, r: dict) -> dict:
    if metric == "throughput":
        return {"throughput": tuple(float(x) for x in r["throughput"]),
                "avg_hops": tuple(float(x) for x in r["avg_hops"]),
                "ejected": tuple(int(x) for x in r["ejected"]),
                "pool_stall": tuple(int(x) for x in r["pool_stall"])}
    lat = {lbl: tuple(_nan_none(v) for v in r[k]) for lbl, k in _LATENCY_KEYS}
    if metric == "latency":
        return lat
    return {"throughput": tuple(float(x) for x in r["delivered"]),
            "offered": tuple(float(x) for x in r["offered"]),
            "dropped": tuple(int(x) for x in r["dropped"]),
            "pool_stall": tuple(int(x) for x in r["pool_stall"]), **lat}


def run_resumable(experiment: Experiment, ckpt_dir: str, *,
                  every: int = 64, keep: int = 3,
                  cache: Optional[SimulatorCache] = None,
                  device=None) -> Result:
    """Run ``experiment`` with checkpointed, resumable execution.

    The Result of :func:`repro_torch.api.run`, bitwise, but killable at
    any point and resumable by calling again with the same ``ckpt_dir``.
    ``every`` is the checkpoint cadence in engine chunks (``completion``)
    or slots (the windowed metrics).  ``device`` as in ``run``: the card
    unless ``"cpu"`` is asked for.
    """
    metric = experiment.resolved_metric()
    if metric == "resilience":
        raise ValueError(
            "resilience runs apply failure transitions from the host at "
            "exact mid-run slots and are not resumable yet; run them "
            "through repro.api.run (their measurement windows are short) "
            "or wrap the whole run under the supervisor instead.")
    dev = resolve_device(device)
    _write_spec(ckpt_dir, experiment)
    _check_runnable(experiment)
    cfg = ResilientConfig(every=every, keep=keep)
    sim = (_make_simulator(experiment.network, experiment.route, dev)
           if cache is None
           else cache.get(experiment.network, experiment.route, dev))
    result = _run_resumable_on(sim, experiment, metric, ckpt_dir, cfg)
    path = os.path.join(ckpt_dir, "result.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(result.to_json(indent=1))
    os.replace(tmp, path)
    return result


def _run_resumable_on(sim, exp: Experiment, metric: str, ckpt_dir: str,
                      cfg: ResilientConfig) -> Result:
    batched = exp.replicas > 1
    seeds = exp.replica_seeds() if batched else None

    if _is_program(exp):
        cp = _collective_program(sim, exp)
        r = run_program_resumable(sim, cp, ckpt=ckpt_dir, chunk=exp.chunk,
                                  max_slots=exp.max_slots, seed=exp.seed,
                                  seeds=seeds, config=cfg)
        if batched:
            per = {"slots": tuple(int(x) for x in r["slots"]),
                   "completed": tuple(bool(x) for x in r["completed"]),
                   "pool_stall": tuple(int(x) for x in r["pool_stall"]),
                   "phase_slots": tuple(tuple(int(v) for v in row)
                                        for row in r["phase_slots"])}
            return _batched_result(exp, seeds, metric, per)
        return Result(experiment=exp, metric=metric, slots=int(r["slots"]),
                      completed=bool(r["completed"]),
                      pool_stall=int(r["pool_stall"]),
                      phase_slots=tuple(int(s) for s in r["phase_slots"]))

    traffic = _to_traffic(exp)
    if metric == "completion":
        expected = sim.S * exp.workload.rounds
        r = run_completion_resumable(sim, traffic, expected, ckpt=ckpt_dir,
                                     chunk=exp.chunk,
                                     max_slots=exp.max_slots,
                                     seed=exp.seed, seeds=seeds, config=cfg)
        if batched:
            per = {"slots": tuple(int(x) for x in r["slots"]),
                   "completed": tuple(bool(x) for x in r["completed"]),
                   "pool_stall": tuple(int(x) for x in r["pool_stall"])}
            return _batched_result(exp, seeds, metric, per)
        return Result(experiment=exp, metric=metric, slots=int(r["slots"]),
                      completed=bool(r["completed"]),
                      pool_stall=int(r["pool_stall"]))

    r = run_window_resumable(sim, traffic, metric=metric, ckpt=ckpt_dir,
                             warm=exp.warm, measure=exp.measure,
                             seed=exp.seed, seeds=seeds, config=cfg)
    if batched:
        return _batched_result(exp, seeds, metric,
                               _batched_window_per(metric, r))
    return _scalar_window_result(exp, metric, r)


def resume(ckpt_dir: str, *, every: int = 64, keep: int = 3,
           cache: Optional[SimulatorCache] = None, device=None) -> Result:
    """Resume (or report) the run stored in ``ckpt_dir`` from its spec and
    latest intact snapshot.  A finished run returns its stored Result
    without recomputation."""
    spec = os.path.join(ckpt_dir, "experiment.json")
    if not os.path.exists(spec):
        raise FileNotFoundError(
            f"{spec} not found — not a resumable checkpoint directory "
            "(run_resumable writes it on first start)")
    done = os.path.join(ckpt_dir, "result.json")
    if os.path.exists(done):
        with open(done) as f:
            return Result.from_json(f.read())
    with open(spec) as f:
        experiment = Experiment.from_json(f.read())
    return run_resumable(experiment, ckpt_dir, every=every, keep=keep,
                         cache=cache, device=device)
