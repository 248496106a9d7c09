"""Frozen, JSON-round-trippable serving-sweep specification.

A :class:`ServingSpec` names one fabric, one arrival process, and a
ladder of offered loads; :func:`repro_torch.serving.sweep.serve_sweep` expands
it into ``serving``-metric :class:`repro_torch.api.Experiment` grid
points and returns the load-latency SLO curve (p50 / p99 / p999 / p9999
vs offered load) plus the saturation knee.  ``python -m repro_torch.api
serve-sweep spec.json`` executes one from a file.  The port's copy of
the reference's ``repro.serving.spec``: the same fields, checks and
JSON.

Optionally the spec carries an LM request (``model`` / ``phase``), in
which case the sweep also runs the bridged collective once per fabric
(:mod:`repro_torch.serving.bridge`) and attaches its completion record — the
"what does one request cost in isolation" companion to the open-loop
curve.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Tuple

from ..api.specs import NetworkSpec, RouteSpec
from ..workloads.patterns import check_arrival

__all__ = ["ServingSpec"]

DEFAULT_LOADS = (0.2, 0.4, 0.6, 0.7, 0.8, 0.9, 0.95)


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """One open-loop serving sweep: fabric x arrival process x load ladder.

    * ``network`` / ``route`` — the fabric, exactly as in ``Experiment``.
    * ``process`` — arrival family (``poisson`` / ``pareto`` / ``diurnal``)
      with its knobs (``pareto_alpha`` / ``pareto_cap`` / ``diurnal_amp`` /
      ``diurnal_period`` / ``arr_depth``).
    * ``loads`` — offered loads swept (packets/slot/endpoint); every load
      must pass :func:`repro_torch.workloads.patterns.check_arrival`.
    * ``sat_ratio`` — the knee rule: the first load whose delivered
      throughput drops below ``sat_ratio * offered`` marks saturation.
    * ``model`` / ``phase`` / ``ranks`` / ``tokens`` / ``batch`` — optional
      LM request attached via :mod:`repro_torch.serving.bridge`
      (``model=""``
      disables the bridge leg).
    """

    network: NetworkSpec
    route: RouteSpec = RouteSpec()
    process: str = "poisson"
    loads: Tuple[float, ...] = DEFAULT_LOADS
    # arrival-process knobs (mirror WorkloadSpec)
    pareto_alpha: float = 1.5
    pareto_cap: int = 64
    diurnal_amp: float = 0.5
    diurnal_period: int = 512
    arr_depth: int = 8
    # measurement
    warm: int = 200
    measure: int = 600
    seed: int = 0
    replicas: int = 1
    max_slots: int = 60_000
    sat_ratio: float = 0.95
    # optional LM-request leg
    model: str = ""
    phase: str = "decode"
    ranks: int = 0
    tokens: int = 256
    batch: int = 1
    name: str = ""

    def __post_init__(self):
        loads = tuple(float(x) for x in self.loads)
        if not loads:
            raise ValueError("loads must name at least one offered load")
        object.__setattr__(self, "loads", loads)
        for load in loads:
            check_arrival(self.process, load, pareto_alpha=self.pareto_alpha,
                          pareto_cap=self.pareto_cap,
                          diurnal_amp=self.diurnal_amp,
                          diurnal_period=self.diurnal_period,
                          arr_depth=self.arr_depth)
        if not 0.0 < self.sat_ratio <= 1.0:
            raise ValueError(f"sat_ratio must be in (0, 1], got "
                             f"{self.sat_ratio}")
        if self.model:
            from .bridge import SERVING_PHASES
            if self.phase not in SERVING_PHASES:
                raise ValueError(f"unknown serving phase {self.phase!r}; "
                                 f"expected one of {SERVING_PHASES}")

    def label(self) -> str:
        if self.name:
            return self.name
        params = ",".join(f"{k}={v}" for k, v in self.network.params)
        return f"{self.network.family}({params})/{self.process}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["network"] = self.network.to_dict()
        d["route"] = self.route.to_dict()
        d["loads"] = list(self.loads)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServingSpec":
        d = dict(d)
        d["network"] = NetworkSpec.from_dict(d["network"])
        if "route" in d:
            d["route"] = RouteSpec.from_dict(d["route"])
        if "loads" in d:
            d["loads"] = tuple(d["loads"])
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ServingSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "ServingSpec":
        return dataclasses.replace(self, **kw)
