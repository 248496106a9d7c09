"""Library of :class:`WorkloadProgram` builders.

The port's own copy of the reference's ``repro.workloads.programs``: for
the same arguments the builders give the same arrays.

Collective schedules lower rank-level phase lists
(:mod:`repro_torch.core.collectives`) onto endpoint-level programs: ranks map
identity onto the first ``ranks`` endpoints, every remaining endpoint is
self-partnered (local fast-path delivery) with the same per-phase message
size — exactly the layout the legacy host loop patched into
``st["partner"]``, so the barrier schedule reproduces it bitwise.

``PROGRAM_BUILDERS`` is the registry the declarative layer dispatches
through; :func:`register_program_builder` adds a new collective in one
call (builder + pattern name), making it reachable from ``WorkloadSpec``
(``pattern=<name>``) and the runner without touching any other list.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..core.collectives import (recursive_doubling_phases,
                                rabenseifner_phases, ring_allreduce_phases)
from .ir import WorkloadProgram
from .patterns import pattern_kinds, register_pattern

__all__ = [
    "all2all_program",
    "rabenseifner_program",
    "ring_allreduce_program",
    "rd_allreduce_program",
    "PROGRAM_BUILDERS",
    "register_program_builder",
    "build_collective_program",
]


def all2all_program(S: int, rounds: int) -> WorkloadProgram:
    """Shifted-exchange All2All: phase ``r`` pairs ``e`` with
    ``(e + r + 1) mod S``, one packet per phase.  Compiled with
    ``schedule="window"`` this is the pipelined All2All (endpoints run up
    to ``window`` rounds ahead of the globally-completed round)."""
    if rounds < 1:
        raise ValueError(f"all2all needs rounds >= 1, got {rounds}")
    if S < 2:
        raise ValueError("all2all needs at least 2 endpoints")
    e = np.arange(S, dtype=np.int64)
    partner = np.stack([(e + r + 1) % S for r in range(rounds)], axis=0)
    return WorkloadProgram(name=f"all2all[{rounds}r]", partner=partner,
                           packets=np.ones((rounds, S), np.int32))


def _rank_phases_to_program(name: str, phases: list, S: int,
                            ranks: int) -> WorkloadProgram:
    if ranks > S:
        raise ValueError(f"{name}: ranks {ranks} > endpoints {S}")
    partner = np.tile(np.arange(S, dtype=np.int64), (len(phases), 1))
    packets = np.empty((len(phases), S), np.int64)
    for p, ph in enumerate(phases):
        partner[p, :ranks] = ph["partner"]
        packets[p, :] = ph["packets"]
    return WorkloadProgram(name=name, partner=partner, packets=packets)


def rabenseifner_program(S: int, ranks: int,
                         vec_packets: int) -> WorkloadProgram:
    """Rabenseifner Allreduce (recursive-halving reduce-scatter +
    recursive-doubling all-gather) over ``ranks`` power-of-two ranks."""
    return _rank_phases_to_program(
        f"rabenseifner[{ranks}x{vec_packets}]",
        rabenseifner_phases(ranks, vec_packets), S, ranks)


def ring_allreduce_program(S: int, ranks: int,
                           vec_packets: int) -> WorkloadProgram:
    """Ring Allreduce: ``2 * (ranks - 1)`` next-neighbour chunk shifts."""
    return _rank_phases_to_program(
        f"ring_allreduce[{ranks}x{vec_packets}]",
        ring_allreduce_phases(ranks, vec_packets), S, ranks)


def rd_allreduce_program(S: int, ranks: int,
                         vec_packets: int) -> WorkloadProgram:
    """Recursive-doubling Allreduce: ``log2(ranks)`` full-vector XOR
    exchanges."""
    return _rank_phases_to_program(
        f"rd_allreduce[{ranks}x{vec_packets}]",
        recursive_doubling_phases(ranks, vec_packets), S, ranks)


# ---------------------------------------------------------------------- #
# collective-pattern -> program dispatch (the workloads registry)
# ---------------------------------------------------------------------- #
def _build_all2all(S: int, *, rounds: int = 0, **_kw) -> WorkloadProgram:
    return all2all_program(S, rounds)


def _build_allreduce(builder: Callable) -> Callable:
    def build(S: int, *, ranks: int = 0, vec_packets: int = 16,
              **_kw) -> WorkloadProgram:
        n = ranks or 1 << (S.bit_length() - 1)
        return builder(S, n, vec_packets)
    return build


PROGRAM_BUILDERS: Dict[str, Callable[..., WorkloadProgram]] = {
    "all2all": _build_all2all,
    "allreduce": _build_allreduce(rabenseifner_program),
    "ring_allreduce": _build_allreduce(ring_allreduce_program),
    "rd_allreduce": _build_allreduce(rd_allreduce_program),
}


def register_program_builder(name: str,
                             builder: Callable[..., WorkloadProgram],
                             *, overwrite: bool = False) -> None:
    """Register a custom collective: ``builder(S, **spec_knobs)`` must
    return a :class:`WorkloadProgram` (it receives ``rounds`` / ``ranks``
    / ``vec_packets`` as keyword arguments; accept ``**_kw`` for the
    ones it ignores).  The pattern name becomes valid ``WorkloadSpec``
    vocabulary and the runner executes it device-resident like the
    built-in collectives."""
    if name in PROGRAM_BUILDERS and not overwrite:
        raise ValueError(f"program builder {name!r} already registered")
    existing = pattern_kinds().get(name)
    if existing not in (None, "collective"):
        raise ValueError(f"pattern {name!r} is already registered as "
                         f"{existing!r}")
    register_pattern(name, "collective", overwrite=existing == "collective")
    PROGRAM_BUILDERS[name] = builder


def build_collective_program(pattern: str, S: int,
                             **params) -> WorkloadProgram:
    """Resolve a collective pattern name and build its program for ``S``
    endpoints.  ``params`` are the pattern's knobs (``rounds`` for
    all2all; ``ranks`` / ``vec_packets`` for the allreduce family)."""
    try:
        builder = PROGRAM_BUILDERS[pattern]
    except KeyError:
        raise KeyError(
            f"no program builder for pattern {pattern!r}; known: "
            f"{tuple(sorted(PROGRAM_BUILDERS))}") from None
    return builder(S, **params)
