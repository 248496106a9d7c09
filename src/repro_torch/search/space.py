"""Candidate encoding and per-family fabric designers.

A :class:`Candidate` is one point of the search space — ``(family,
radix, f, policy, vcs)``.  A *designer* maps the point plus the spec's
fixed endpoint count to concrete constructor kwargs for that family
(:data:`repro_torch.core.TOPOLOGY_FAMILIES` vocabulary), mirroring the
paper's sizing rules:

* ``mrls`` — :func:`repro_torch.core.analytics.mrls_design`: ``d = R/(1+f)``
  endpoint ports, ``u = R - d`` uplinks, leaf count rounded up until
  ``u*n1 % R == 0``.
* ``jellyfish`` — same port split on a flat random regular graph:
  ``r = R - d`` network ports per switch, switch count rounded up to an
  even-stub population.
* ``fat_tree`` — smallest height whose full tree reaches the target
  (``f`` accepted but unused — the folded Clos has no thickness knob).

Designers live in a registry (:func:`register_designer`) so downstream
families can
join the search space without touching the loop.  Invalid points (odd
fat-tree radix, degenerate port splits, ...) raise :class:`DesignError`;
the loop records them as infeasible instead of crashing the search.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Tuple

from ..api.specs import Experiment, NetworkSpec
from ..core import analytics
from .spec import SearchSpec

__all__ = ["Candidate", "DesignError", "register_designer",
           "designer_families", "design_network", "candidate_experiment",
           "axis_values", "space_size"]


class DesignError(ValueError):
    """The (family, radix, f) point has no valid instance at this
    endpoint count — the candidate is infeasible by construction."""


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One search-space point.  Hashable — the loop dedups on it."""

    family: str
    radix: int
    f: float
    policy: str
    vcs: int

    def label(self) -> str:
        return (f"{self.family}.r{self.radix}.f{self.f:g}"
                f".{self.policy}.v{self.vcs}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Candidate":
        return cls(family=d["family"], radix=int(d["radix"]),
                   f=float(d["f"]), policy=d["policy"], vcs=int(d["vcs"]))


def _split_ports(radix: int, f: float) -> Tuple[int, int]:
    """Split ``radix`` into (network_ports, endpoint_ports) at thickness
    ``f`` = network/endpoint — the paper's ``u/d``."""
    d = max(1, round(radix / (1.0 + f)))
    u = radix - d
    if u < 1:
        raise DesignError(f"radix {radix} at f={f:g} leaves no network "
                          "ports")
    return u, d


def _design_mrls(endpoints: int, radix: int, f: float, seed: int) -> dict:
    n1, n2, u, d = analytics.mrls_design(endpoints, radix, f)
    if n2 < 2:
        raise DesignError(f"mrls at S={endpoints}, R={radix}, f={f:g} "
                          f"needs >= 2 spines, designed {n2}")
    return {"n_leaves": n1, "u": u, "d": d, "seed": seed}


def _design_jellyfish(endpoints: int, radix: int, f: float,
                      seed: int) -> dict:
    r, d = _split_ports(radix, f)
    if r < 2:
        raise DesignError(f"jellyfish at R={radix}, f={f:g} leaves r={r} "
                          "network ports (needs >= 2)")
    n = max(r + 1, math.ceil(endpoints / d))
    if (n * r) % 2:
        n += 1                                  # even stub population
    return {"n_switches": n, "r": r, "d": d, "seed": seed}


def _design_fat_tree(endpoints: int, radix: int, f: float,
                     seed: int) -> dict:
    if radix % 2 or radix < 4:
        raise DesignError(f"fat_tree needs an even radix >= 4, got {radix}")
    k = radix // 2
    h = 1
    while 2 * k ** (h + 1) < endpoints:
        h += 1
        if h > 8:
            raise DesignError(f"fat_tree radix {radix} cannot reach "
                              f"S={endpoints} within 8 levels")
    return {"radix": radix, "h": h}


_DESIGNERS: dict = {
    "mrls": _design_mrls,
    "jellyfish": _design_jellyfish,
    "fat_tree": _design_fat_tree,
}


def register_designer(family: str,
                      designer: Callable[[int, int, float, int], dict],
                      *, overwrite: bool = False) -> None:
    """Register ``designer(endpoints, radix, f, seed) -> constructor kwargs``
    so ``family`` candidates can be instantiated by the search loop.
    Re-registering the same function is a no-op; another function for a
    known family needs ``overwrite=True``."""
    if family in _DESIGNERS and not overwrite:
        if _DESIGNERS[family] is designer:
            return
        raise ValueError(f"designer for family {family!r} already "
                         "registered with a different function (pass "
                         "overwrite=True to replace it)")
    _DESIGNERS[family] = designer


def designer_families() -> tuple:
    return tuple(sorted(_DESIGNERS))


def design_network(cand: Candidate, endpoints: int,
                   seed: int = 0) -> NetworkSpec:
    """Instantiate ``cand`` at ``endpoints`` as a :class:`NetworkSpec`.

    Raises :class:`DesignError` for infeasible points and ``KeyError``
    for families without a designer.
    """
    try:
        designer = _DESIGNERS[cand.family]
    except KeyError:
        raise KeyError(
            f"no designer for topology family {cand.family!r}; known: "
            f"{designer_families()} (register_designer adds more)") from None
    return NetworkSpec(cand.family, designer(endpoints, cand.radix,
                                             cand.f, seed))


def candidate_experiment(spec: SearchSpec, cand: Candidate,
                         network: NetworkSpec, *,
                         stage: str) -> Experiment:
    """The runnable :class:`Experiment` for one candidate at one
    successive-halving stage (``"screen"`` or ``"full"``)."""
    warm, measure = ((spec.screen_warm, spec.screen_measure)
                     if stage == "screen" else (spec.warm, spec.measure))
    route = dataclasses.replace(spec.route, policy=cand.policy,
                                vcs=cand.vcs)
    return Experiment(
        network=network, route=route, workload=spec.workload,
        name=f"{spec.label()}.{cand.label()}.{stage}",
        seed=spec.seed, replicas=spec.replicas,
        warm=warm, measure=measure, max_slots=spec.max_slots)


def axis_values(spec: SearchSpec) -> dict:
    """The per-axis value tuples, in sampling order."""
    return {"family": spec.families, "radix": spec.radix, "f": spec.f,
            "policy": spec.policies, "vcs": spec.vcs}


def space_size(spec: SearchSpec) -> int:
    size = 1
    for vals in axis_values(spec).values():
        size *= len(vals)
    return size
