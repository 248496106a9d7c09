"""Topology-family resolution for :class:`NetworkSpec`, and the pattern
registry as the CLI lists it."""
from __future__ import annotations

from ..core import TOPOLOGY_FAMILIES
from ..core.topology import Topology
from ..workloads.patterns import ENGINE_PATTERNS, pattern_kinds
from .specs import NetworkSpec

__all__ = ["topology_families", "build_network", "network_topology",
           "workload_patterns"]


def workload_patterns() -> tuple:
    """``(name, kind, ported)`` for every spec-level workload pattern,
    sorted by name; ``ported`` says whether the port runs it (the
    Bernoulli families directly, the arrival families as
    ``Traffic("arrival")``, every collective as a workload program or,
    for the free-running ``all2all``, directly)."""
    return tuple((name, kind, name in ENGINE_PATTERNS
                  or kind in ("collective", "arrival"))
                 for name, kind in sorted(pattern_kinds().items())
                 if kind != "engine")


def topology_families() -> tuple:
    return tuple(sorted(TOPOLOGY_FAMILIES))


def build_network(spec: NetworkSpec) -> Topology:
    """Resolve ``spec.family`` and build the topology from ``spec.params``."""
    make = TOPOLOGY_FAMILIES.get(spec.family)
    if make is None:
        raise KeyError(f"unknown topology family {spec.family!r}; known: "
                       f"{topology_families()}")
    return make(**spec.param_dict())


# the last fabric's topology: pricing it (the admission gate, the
# search's screen) and building its simulator then share one host build
_topo_memo: dict = {}


def network_topology(spec: NetworkSpec) -> Topology:
    """``build_network(spec)``, kept for the next call with the same
    fabric (one fabric is kept)."""
    key = (spec.family, spec.params)
    topo = _topo_memo.get(key)
    if topo is None:
        _topo_memo.clear()
        topo = _topo_memo[key] = build_network(spec)
    return topo
