"""Resumable runs to completion: kill -9 loses a segment, not a run.

The engine's loops (``run_program`` / ``run_completion`` /
``run_chunk``) advance a state in place on the device.  This module
drives them in **bounded segments** (``budget_chunks`` chunks, or a
fixed slot count for the windowed metrics) and snapshots the state dict
through :class:`repro_torch.checkpointing.Checkpointer` at every segment
boundary: atomic rename, bounded retention, a synchronous host copy.
Segments, fingerprints, ``meta`` fields and the on-disk layout are the
reference's (``repro.runtime.resilient``), so both write the same
sequence of snapshots up to the port's state layout (the pad slot of the
pool tensors, the key and mask words as int32 views).

Bitwise contract
----------------
A bounded segment's chunks are the unbounded loop's (the budget only
counts them), and the snapshot is a host copy of the state the segment
returns, taken before the next segment advances it, so:

* a chain of segments equals one unbounded call, bitwise;
* a run SIGKILLed between (or during) segments and resumed from the
  latest checkpoint replays the remaining segments bitwise: the PRNG
  ``key``, the phase registers, queue rings and free list all ride in
  the snapshot;
* a checkpoint interrupted mid-write is discarded by the atomic rename,
  so a resume falls back to the previous boundary.

A snapshot holds the full engine state dict (plus the ``done``
completion-slot array for ``run_completion`` and the measurement
window's base counters for the windowed runs), never the simulator's
own tables or index tensors: those are rebuilt from the spec on resume.
A fingerprint of the run's configuration is stored in the checkpoint's
meta and checked on restore, so resuming with a different spec fails
loudly instead of silently diverging.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

from ..checkpointing.checkpoint import Checkpointer
from ..simulator.engine import LATENCY_QS, Traffic, percentiles

__all__ = ["ResilientConfig", "open_checkpointer", "run_program_resumable",
           "run_completion_resumable", "run_window_resumable"]


@dataclasses.dataclass(frozen=True)
class ResilientConfig:
    """Segment and retention knobs shared by the resumable runs.

    ``every`` is the segment length: chunks a call for the program and
    completion loops, slots a call for the windowed metrics.  Smaller
    means a finer resume granularity and more snapshots; the results are
    bitwise the same either way.
    """

    every: int = 64
    keep: int = 3

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")


def open_checkpointer(ckpt: Union[str, Checkpointer],
                      keep: int = 3) -> Checkpointer:
    if isinstance(ckpt, Checkpointer):
        return ckpt
    return Checkpointer(ckpt, keep=keep)


def _traffic_desc(traffic: Traffic) -> str:
    # Traffic is a frozen dataclass of scalars: its repr is deterministic
    # and names every field that shapes the run
    return repr(traffic)


def _seed_desc(seed: int, seeds) -> Union[int, list]:
    return [int(s) for s in seeds] if seeds is not None else int(seed)


def _check_fingerprint(meta: dict, fp: dict, where: str) -> None:
    got = meta.get("fingerprint")
    if got != fp:
        diff = {k: (got.get(k) if isinstance(got, dict) else None, fp[k])
                for k in fp
                if not isinstance(got, dict) or got.get(k) != fp[k]}
        raise ValueError(
            f"checkpoint in {where} was written by a different run "
            f"configuration; refusing to resume (mismatched fields: "
            f"{diff}).  Point --ckpt-dir at a fresh directory or rerun "
            "with the original spec.")


def _restore(ck: Checkpointer, template: dict, step: int, fp: dict):
    tree, meta = ck.restore(template, step)
    _check_fingerprint(meta, fp, ck.dir)
    return tree, meta


# ---------------------------------------------------------------------- #
# collective programs
# ---------------------------------------------------------------------- #
def run_program_resumable(sim, program, *, ckpt, chunk: int = 16,
                          max_slots: int = 60_000, seed: int = 0,
                          seeds=None,
                          config: ResilientConfig = ResilientConfig()) -> dict:
    """:meth:`Simulator.run_program`, checkpointed at every
    ``every``-chunk boundary.  Returns the engine's result dict plus
    ``segments`` (the segment count, resumed ones included) and
    ``resumed_from`` (the checkpoint step picked up, ``None`` for a
    fresh run).  Bitwise the unbounded call, interrupted or not.
    """
    ck = open_checkpointer(ckpt, config.keep)
    fp = {"kind": "program", "chunk": int(chunk),
          "max_slots": int(max_slots), "every": int(config.every),
          "schedule": program.schedule, "window": int(program.window),
          "n_phases": int(program.n_phases), "S": int(sim.S),
          "seed": _seed_desc(seed, seeds)}
    st = (sim.make_program_batch_state(program, seeds)
          if seeds is not None else sim.make_program_state(program, seed))
    latest = ck.latest_step()
    seg, resumed = 0, None
    if latest is not None:
        tree, meta = _restore(ck, {"state": st}, latest, fp)
        st, seg, resumed = tree["state"], int(meta["segment"]), latest
    running = True
    while running:
        r = sim.run_program(program, chunk=chunk, max_slots=max_slots,
                            state=st, budget_chunks=config.every)
        st, running = r["state"], r["running"]
        seg += 1
        ck.save(seg, {"state": st},
                meta={"fingerprint": fp, "segment": seg,
                      "running": bool(running)})
    out = dict(r)
    out["segments"] = seg
    out["resumed_from"] = resumed
    return out


# ---------------------------------------------------------------------- #
# free-running completion (the engine's all2all)
# ---------------------------------------------------------------------- #
def run_completion_resumable(sim, traffic: Traffic, expected: int, *, ckpt,
                             chunk: int = 128, max_slots: int = 100_000,
                             seed: int = 0, seeds=None,
                             config: ResilientConfig = ResilientConfig()
                             ) -> dict:
    """:meth:`Simulator.run_completion` in checkpointed segments.  The
    per-replica ``done`` completion-slot array is part of every
    snapshot, so a resumed run keeps the exact slots already recorded."""
    ck = open_checkpointer(ckpt, config.keep)
    fp = {"kind": "completion", "chunk": int(chunk),
          "max_slots": int(max_slots), "every": int(config.every),
          "expected": int(expected), "S": int(sim.S),
          "traffic": _traffic_desc(traffic),
          "seed": _seed_desc(seed, seeds)}
    st = (sim.make_batch_state(traffic, seeds) if seeds is not None
          else sim.make_state(traffic, seed))
    done = np.full(tuple(st["ejected"].shape), -1, np.int32)
    latest = ck.latest_step()
    seg, resumed = 0, None
    if latest is not None:
        tree, meta = _restore(ck, {"state": st, "done": done}, latest, fp)
        st, done = tree["state"], tree["done"]
        seg, resumed = int(meta["segment"]), latest
    running = True
    while running:
        r = sim.run_completion(traffic, expected, chunk=chunk,
                               max_slots=max_slots, state=st,
                               budget_chunks=config.every, done=done)
        st, done, running = r["state"], r["done"], r["running"]
        seg += 1
        ck.save(seg, {"state": st, "done": done},
                meta={"fingerprint": fp, "segment": seg,
                      "running": bool(running)})
    out = dict(r)
    out["segments"] = seg
    out["resumed_from"] = resumed
    return out


# ---------------------------------------------------------------------- #
# windowed metrics (throughput / latency / serving)
# ---------------------------------------------------------------------- #
# every window metric's base snapshot is a subset of these state counters
_WINDOW_COUNTERS = ("ejected", "hop_sum", "pool_stall", "lat_hist",
                    "arrived", "arr_drop")
_SERVING_KEYS = ("lat_hist", "ejected", "arrived", "arr_drop", "pool_stall")


def _host(st: dict, keys) -> dict:
    """Host copies (fresh memory: the engine advances ``st`` in place) of
    the entries ``keys`` of ``st``."""
    return {k: st[k].detach().to("cpu", copy=True).numpy() for k in keys}


def run_window_resumable(sim, traffic: Traffic, *, metric: str, ckpt,
                         warm: int = 200, measure: int = 400, seed: int = 0,
                         seeds=None,
                         config: ResilientConfig = ResilientConfig()) -> dict:
    """``run_throughput`` / ``run_latency`` / ``run_serving`` in
    checkpointed ``every``-slot segments.

    The warm / measure structure is kept exactly: segments never cross
    the warm boundary, the base counters copied there are part of every
    later checkpoint, and the window's deltas are the differences of the
    same int32 counters the engine's measurement runs subtract, so the
    metrics are bitwise the one-shot runs'.
    """
    if metric not in ("throughput", "latency", "serving"):
        raise ValueError(f"run_window_resumable supports "
                         f"throughput/latency/serving, got {metric!r}")
    if metric == "serving" and traffic.pattern != "arrival":
        raise ValueError(f"serving needs Traffic('arrival'), got "
                         f"{traffic.pattern!r}")
    ck = open_checkpointer(ckpt, config.keep)
    batched = seeds is not None
    fp = {"kind": "window", "metric": metric, "warm": int(warm),
          "measure": int(measure), "every": int(config.every),
          "S": int(sim.S), "traffic": _traffic_desc(traffic),
          "seed": _seed_desc(seed, seeds)}
    st = (sim.make_batch_state(traffic, seeds) if batched
          else sim.make_state(traffic, seed))
    keys = tuple(k for k in _WINDOW_COUNTERS if k in st)
    base0 = {k: np.zeros_like(v) for k, v in _host(st, keys).items()}
    latest = ck.latest_step()
    cursor, seg, resumed, base = 0, 0, None, None
    if latest is not None:
        tree, meta = _restore(ck, {"state": st, "base": base0}, latest, fp)
        st = tree["state"]
        base = tree["base"] if meta["has_base"] else None
        cursor, seg, resumed = int(meta["cursor"]), int(meta["segment"]), \
            latest
    total = warm + measure

    def save(running: bool):
        ck.save(seg, {"state": st, "base": base or base0},
                meta={"fingerprint": fp, "segment": seg, "cursor": cursor,
                      "has_base": base is not None,
                      "running": bool(running)})

    while True:
        if cursor >= warm and base is None:
            # the measurement window's base: the counters the engine's
            # measurement runs copy before the measure slots
            base = _host(st, keys)
            seg += 1
            save(running=cursor < total)
        if cursor >= total:
            break
        bound = warm if cursor < warm else total
        n = min(config.every, bound - cursor)
        st = sim.run_chunk(st, traffic, n)
        cursor += n
        if cursor < warm or base is not None:
            # (at the warm boundary the save above covers this segment)
            seg += 1
            save(running=cursor < total)

    sth = _host(st, keys)
    m = {k: sth[k] - base[k] for k in keys}
    S = sim.S
    extra = {"state": st, "segments": seg, "resumed_from": resumed}
    if metric == "throughput":
        e, h = m["ejected"], m["hop_sum"]
        if batched:
            return {"throughput": e / (S * measure),
                    "avg_hops": h / np.maximum(e, 1),
                    "ejected": sth["ejected"],
                    "pool_stall": m["pool_stall"], **extra}
        return {"throughput": int(e) / (S * measure),
                "avg_hops": int(h) / max(int(e), 1),
                "ejected": int(sth["ejected"]),
                "pool_stall": int(m["pool_stall"]), **extra}
    if metric == "latency":
        hist = m["lat_hist"]
        if batched:
            per = [percentiles(row, LATENCY_QS) for row in hist]
            out = {"hist": hist, **extra}
            for q in LATENCY_QS:
                k = f"p{q}"
                out[k] = np.asarray([p[k] for p in per])
            return out
        return {"hist": hist, **percentiles(hist, LATENCY_QS), **extra}
    serving = {k: m[k] for k in _SERVING_KEYS}
    return {**sim._serving_metrics(serving, S, measure), **extra}
