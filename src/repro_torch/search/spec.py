"""Frozen, JSON-round-trippable design-space search specification.

The port's copy of the reference's ``repro.search.spec``: a
:class:`SearchSpec` names the *design space* the paper argues over —
(topology family, radix, thickness ``f``, routing policy, VC count) at a
fixed endpoint count — plus the search protocol: objective, strategy
(``random`` | ``evolutionary``), candidate budget, successive-halving
screen/promotion windows, and the memory budget the estimator prunes
against *before* anything is built.  Hashable, losslessly
``to_dict()``/``from_dict()`` round-trippable and validated at
construction, so the same JSON files load in both packages.  ``python -m
repro_torch.api search spec.json`` executes one from a file.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional, Tuple

from ..api.specs import RouteSpec, WorkloadSpec
from ..core.routing import POLICIES

__all__ = ["SearchSpec", "OBJECTIVES", "STRATEGIES"]

OBJECTIVES = ("throughput_per_link", "throughput")
STRATEGIES = ("random", "evolutionary")


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One design-space search at a fixed endpoint count.

    Axes (the cartesian space candidates are drawn from):

    * ``families`` — topology families with a registered designer
      (:mod:`repro_torch.search.space`; ``mrls``/``jellyfish``/``fat_tree``
      out of the box).
    * ``radix`` — switch radix R per candidate.
    * ``f`` — thickness (network-port : endpoint-port ratio ``u/d``;
      the paper's passes knob).  Families without the knob (fat_tree)
      accept and record it without using it.
    * ``policies`` / ``vcs`` — routing-policy and virtual-channel axes
      applied on top of ``route``.

    Protocol:

    * ``objective`` — ``throughput_per_link`` (delivered throughput /
      links-per-endpoint, the paper's throughput-per-cost lens) or raw
      ``throughput``.
    * ``strategy`` — ``random`` draws ``budget`` distinct candidates;
      ``evolutionary`` seeds half the budget randomly and fills the rest
      by mutating one axis of screened elites.
    * ``budget`` — total candidates drawn (pruned ones count: they were
      drawn, the estimator refused them).
    * ``screen_warm``/``screen_measure`` — the cheap screening window
      every admitted candidate gets; ``warm``/``measure`` — the full
      window survivors are promoted to.
    * ``survivors`` — promotion fraction for successive halving (the
      top ``ceil(survivors * screened)`` candidates re-run full; the
      screen-stage Pareto frontier is always promoted on top of the
      quota so the cost axis stays covered).
    * ``max_slots`` — completion-run ceiling per candidate (all2all
      workloads); candidates that blow it read as zero throughput
      instead of stalling the search for the full default budget.
    * ``mem_budget_mib`` — per-candidate resident peak budget
      (``estimate_memory(...)["peak_bytes"]``); candidates over it are
      pruned before anything is built.  ``None`` skips the explicit
      budget and leaves only the device admission gate
      (:mod:`repro_torch.api.admission`).
    """

    endpoints: int
    families: Tuple[str, ...] = ("mrls", "jellyfish", "fat_tree")
    radix: Tuple[int, ...] = (16, 24, 32)
    f: Tuple[float, ...] = (1.0, 2.0)
    policies: Tuple[str, ...] = ("polarized",)
    vcs: Tuple[int, ...] = (4,)
    route: RouteSpec = RouteSpec()
    workload: WorkloadSpec = WorkloadSpec("uniform", load=1.0)
    objective: str = "throughput_per_link"
    strategy: str = "random"
    budget: int = 16
    survivors: float = 0.5
    screen_warm: int = 30
    screen_measure: int = 60
    warm: int = 100
    measure: int = 200
    max_slots: int = 60_000
    seed: int = 0
    replicas: int = 1
    mem_budget_mib: Optional[float] = None
    name: str = ""

    def __post_init__(self):
        for field, cast in (("families", str), ("policies", str),
                            ("radix", int), ("vcs", int), ("f", float)):
            vals = getattr(self, field)
            if isinstance(vals, (str, int, float)):
                vals = (vals,)
            vals = tuple(cast(v) for v in vals)
            if not vals:
                raise ValueError(f"SearchSpec.{field} must name at least "
                                 "one value")
            object.__setattr__(self, field, vals)
        if not isinstance(self.route, RouteSpec):
            object.__setattr__(self, "route",
                               RouteSpec.from_dict(self.route))
        if not isinstance(self.workload, WorkloadSpec):
            object.__setattr__(self, "workload",
                               WorkloadSpec.from_dict(self.workload))
        if self.endpoints < 4:
            raise ValueError(f"endpoints must be >= 4, got {self.endpoints}")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"known: {OBJECTIVES}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"known: {STRATEGIES}")
        unknown = [p for p in self.policies if p not in POLICIES]
        if unknown:
            raise ValueError(f"unknown routing policies {unknown}; "
                             f"known: {POLICIES}")
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        if not 0.0 < self.survivors <= 1.0:
            raise ValueError(f"survivors must lie in (0, 1], got "
                             f"{self.survivors}")
        for field in ("screen_warm", "screen_measure", "warm", "measure",
                      "max_slots"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.mem_budget_mib is not None and self.mem_budget_mib <= 0:
            raise ValueError(f"mem_budget_mib must be > 0, got "
                             f"{self.mem_budget_mib}")

    # ------------------------------------------------------------------ #
    def label(self) -> str:
        return self.name or f"search.{self.endpoints}.{self.objective}"

    def mem_budget_bytes(self) -> Optional[int]:
        if self.mem_budget_mib is None:
            return None
        return int(self.mem_budget_mib * (1 << 20))

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for field in ("families", "radix", "f", "policies", "vcs"):
            d[field] = list(d[field])
        d["route"] = self.route.to_dict()
        d["workload"] = self.workload.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "SearchSpec":
        d = dict(d)
        if "route" in d:
            d["route"] = RouteSpec.from_dict(d["route"])
        if "workload" in d:
            d["workload"] = WorkloadSpec.from_dict(d["workload"])
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "SearchSpec":
        return cls.from_dict(json.loads(s))
