"""Frozen, hashable, JSON-serializable experiment specs.

The port's own copy of the reference's spec layer: an
:class:`Experiment` composes a :class:`NetworkSpec` (what fabric), a
:class:`RouteSpec` (how packets move) and a :class:`WorkloadSpec` (what
traffic), plus the measurement protocol.  The same JSON files load in
both packages and ``to_dict()`` gives the same dict, so their
:class:`~repro_torch.api.runner.Result` records compare field for field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Tuple

from ..core.failures import FailureSchedule
from ..workloads.patterns import (check_arrival, check_pattern,
                                  check_schedule)

__all__ = ["NetworkSpec", "RouteSpec", "WorkloadSpec", "Experiment"]


def _freeze_value(key: str, v):
    """Recursively convert lists to tuples and reject non-JSON leaves."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(key, x) for x in v)
    if not isinstance(v, (int, float, str, bool, type(None))):
        raise TypeError(f"NetworkSpec param {key!r} must be a JSON scalar "
                        f"or list thereof, got {type(v).__name__}")
    return v


def _freeze_params(params) -> Tuple[Tuple[str, Any], ...]:
    """Normalize a params mapping to a sorted tuple of pairs (hashable)."""
    if isinstance(params, Mapping):
        items = params.items()
    else:
        items = [(k, v) for k, v in params]
    return tuple((str(k), _freeze_value(str(k), v)) for k, v in sorted(items))


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """A topology family name plus constructor kwargs (a sorted tuple of
    pairs, so the spec is hashable), and optionally a frozen
    :class:`~repro_torch.core.FailureSchedule` of link and switch events
    applied mid-run.  The schedule is part of the spec and its hash, so a
    simulator cache never mixes a degraded fabric with its pristine
    twin; it is validated against the topology before the tables are
    built."""

    family: str
    params: Tuple[Tuple[str, Any], ...] = ()
    failures: Optional[FailureSchedule] = None

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze_params(self.params))
        if self.failures is not None and not isinstance(self.failures,
                                                        FailureSchedule):
            object.__setattr__(self, "failures",
                               FailureSchedule.from_dict(self.failures))

    def param_dict(self) -> dict:
        return {k: v for k, v in self.params}

    def to_dict(self) -> dict:
        d = {"family": self.family, "params": self.param_dict()}
        if self.failures is not None:
            d["failures"] = self.failures.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "NetworkSpec":
        failures = d.get("failures")
        if failures is not None and not isinstance(failures,
                                                   FailureSchedule):
            failures = FailureSchedule.from_dict(failures)
        return cls(family=d["family"], params=d.get("params", {}),
                   failures=failures)


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """Routing policy plus the switch resources it runs on.

    ``backend`` is read for compatibility with the reference's spec files
    and has no effect here: the device picks the implementation (the CUDA
    kernels on the card, their plain versions on the CPU).
    """

    policy: str = "polarized"
    vcs: int = 4
    max_hops: int = 8
    deroute_penalty: float = 8.0
    queue_depth: int = 8
    out_queue: int = 4
    speedup: int = 2
    endpoint_queue: int = 4
    pool: Optional[int] = None
    hist_bins: int = 4096
    backend: str = "xla"

    def to_sim_config(self, seed: int = 0):
        from ..simulator.engine import SimConfig

        return SimConfig(
            policy=self.policy, vcs=self.vcs, queue_depth=self.queue_depth,
            out_queue=self.out_queue, speedup=self.speedup,
            endpoint_queue=self.endpoint_queue, max_hops=self.max_hops,
            deroute_penalty=self.deroute_penalty, pool=self.pool,
            hist_bins=self.hist_bins, seed=seed,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RouteSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Traffic program: the reference's fields and validation.  The port
    runs the Bernoulli families, every collective (the scheduled ones
    and those added through ``register_program_builder`` as workload
    programs) and the open-loop arrival families ``poisson``, ``pareto``
    and ``diurnal`` (with their knobs ``pareto_alpha``, ``pareto_cap``,
    ``diurnal_amp``, ``diurnal_period`` and ``arr_depth``)."""

    pattern: str = "uniform"
    load: float = 1.0
    rounds: int = 0              # all2all
    ranks: int = 0               # allreduce family; 0 -> largest pow2 <= S
    vec_packets: int = 16        # allreduce vector size (packets)
    elephant_frac: float = 0.1   # mice_elephant
    elephant_size: int = 16
    schedule: str = ""           # collective mode: "" | barrier | window
    window: int = 1              # lookahead depth for schedule="window"
    shift: int = 1               # shift: dst = (e + shift) mod S
    hot_frac: float = 0.1        # hotspot: fraction of incast messages
    hot_count: int = 1           # hotspot: number of hot endpoints
    burst_len: float = 8.0       # bursty: mean burst duration (slots)
    burst_load: float = 1.0      # bursty: injection probability in-burst
    pareto_alpha: float = 1.5    # pareto: bounded-Pareto shape (> 1)
    pareto_cap: int = 64         # pareto: batch-size cap (packets)
    diurnal_amp: float = 0.5     # diurnal: relative amplitude [0, 1]
    diurnal_period: int = 512    # diurnal: modulation period (slots >= 2)
    arr_depth: int = 8           # per-endpoint pending-batch FIFO depth

    def __post_init__(self):
        kind = check_pattern(self.pattern)
        check_schedule(self.schedule, self.window)
        if kind == "arrival":
            check_arrival(self.pattern, self.load,
                          pareto_alpha=self.pareto_alpha,
                          pareto_cap=self.pareto_cap,
                          diurnal_amp=self.diurnal_amp,
                          diurnal_period=self.diurnal_period,
                          arr_depth=self.arr_depth)
        if self.schedule and kind != "collective":
            raise ValueError(
                f"schedule={self.schedule!r} needs a collective pattern, "
                f"got {self.pattern!r} ({kind})")
        if self.pattern == "all2all" and self.rounds <= 0:
            raise ValueError("all2all needs rounds > 0 (0 rounds would "
                             "report instant completion of an empty program)")
        if self.pattern in ("allreduce", "rd_allreduce") and self.ranks:
            if self.ranks < 2 or self.ranks & (self.ranks - 1):
                raise ValueError(
                    f"{self.pattern} ranks must be a power of two >= 2 "
                    f"(recursive halving/doubling), got {self.ranks}")
        if self.pattern == "ring_allreduce" and self.ranks and self.ranks < 2:
            raise ValueError(f"ring_allreduce needs ranks >= 2, got "
                             f"{self.ranks}")
        if self.pattern == "shift" and self.shift == 0:
            raise ValueError("shift pattern needs a non-zero shift offset")
        if self.pattern == "hotspot":
            if not 0.0 < self.hot_frac <= 1.0:
                raise ValueError(f"hot_frac must be in (0, 1], got "
                                 f"{self.hot_frac}")
            if self.hot_count < 1:
                raise ValueError(f"hot_count must be >= 1, got "
                                 f"{self.hot_count}")
        if self.pattern == "bursty":
            if not 0.0 < self.burst_load <= 1.0:
                raise ValueError(f"burst_load must be in (0, 1], got "
                                 f"{self.burst_load}")
            if self.burst_len < 1.0:
                raise ValueError(f"burst_len must be >= 1 slot, got "
                                 f"{self.burst_len}")
            if self.load > self.burst_load:
                raise ValueError(
                    f"bursty load {self.load} exceeds burst_load "
                    f"{self.burst_load}: the long-run offered load can "
                    "never exceed the in-burst intensity")
            duty_max = self.burst_len / (self.burst_len + 1.0)
            if self.load > self.burst_load * duty_max:
                raise ValueError(
                    f"bursty duty cycle {self.load / self.burst_load:.3f} "
                    f"is unreachable: with burst_len {self.burst_len} the "
                    f"ON fraction tops out at {duty_max:.3f}, so the "
                    "long-run offered load would silently undershoot "
                    "`load` — raise burst_len or burst_load")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "WorkloadSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One runnable scenario: fabric x routing x workload + measurement.

    ``metric`` is ``auto`` (Bernoulli patterns -> ``throughput``,
    collectives -> ``completion``, arrival processes -> ``serving``, and
    any pattern on a network with a non-empty failure schedule ->
    ``resilience``), ``throughput``, ``latency``, ``completion``,
    ``serving`` or ``resilience``.  ``seed`` drives the
    simulator's PRNG stream; ``replicas`` > 1 runs the seeds ``seed ..
    seed + replicas - 1`` as one batched run.
    """

    network: NetworkSpec
    route: RouteSpec = RouteSpec()
    workload: WorkloadSpec = WorkloadSpec()
    name: str = ""
    metric: str = "auto"
    seed: int = 0
    replicas: int = 1
    warm: int = 200
    measure: int = 400
    chunk: int = 16
    max_slots: int = 60_000

    def __post_init__(self):
        if self.metric not in ("auto", "throughput", "latency", "completion",
                               "serving", "resilience"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")

    def resolved_metric(self) -> str:
        if self.metric != "auto":
            return self.metric
        kind = check_pattern(self.workload.pattern)
        if kind == "collective":
            return "completion"
        if kind == "arrival":
            return "serving"
        if self.network.failures is not None and len(self.network.failures):
            return "resilience"
        return "throughput"

    def replica_seeds(self) -> Tuple[int, ...]:
        """The per-replica seeds a batched run uses: ``seed .. seed+R-1``."""
        return tuple(self.seed + i for i in range(self.replicas))

    def label(self) -> str:
        return self.name or (f"{self.network.family}"
                             f".{self.route.policy}.{self.workload.pattern}")

    def to_dict(self) -> dict:
        return {
            "network": self.network.to_dict(),
            "route": self.route.to_dict(),
            "workload": self.workload.to_dict(),
            "name": self.name,
            "metric": self.metric,
            "seed": self.seed,
            "replicas": self.replicas,
            "warm": self.warm,
            "measure": self.measure,
            "chunk": self.chunk,
            "max_slots": self.max_slots,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Experiment":
        d = dict(d)
        return cls(
            network=NetworkSpec.from_dict(d.pop("network")),
            route=RouteSpec.from_dict(d.pop("route", {})),
            workload=WorkloadSpec.from_dict(d.pop("workload", {})),
            **d,
        )

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Experiment":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------------ #
    def override(self, path: str, value) -> "Experiment":
        """Return a copy with the dotted ``path`` replaced by ``value``.

        Paths address the spec tree: ``seed``, ``workload.load``,
        ``route.policy``, ``network.params.u``, ...  This is the primitive
        :func:`repro_torch.api.sweep` expands axes with.
        """
        head, _, rest = path.partition(".")
        if not rest:
            return dataclasses.replace(self, **{head: value})
        sub = getattr(self, head)
        if head == "network":
            field, _, leaf = rest.partition(".")
            if field == "params":
                params = sub.param_dict()
                params[leaf] = value
                new = dataclasses.replace(sub, params=params)
            else:
                new = dataclasses.replace(sub, **{rest: value})
        elif head in ("route", "workload"):
            new = dataclasses.replace(sub, **{rest: value})
        else:
            raise KeyError(f"cannot override {path!r}")
        return dataclasses.replace(self, **{head: new})
