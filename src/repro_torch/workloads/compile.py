"""Compile a :class:`WorkloadProgram` to the schedule arrays of the
engine's phase scheduler.

The port's own copy of the reference's ``repro.workloads.compile``, with
int32 torch tensors in place of its jnp arrays.  They stay on the host
in the compiled form: :meth:`repro_torch.simulator.engine.Simulator.
make_program_state` copies them onto the simulator's device, so a
program compiled once runs on any device.

* ``partner`` / ``packets``     — int32 ``[n_phases, S]``, gathered
  row-wise (barrier) or element-wise (windowed) at inject;
* ``expected``                  — int32 ``[n_phases]`` per-phase ejection
  targets (``sum(packets[p])``), the phase-advance thresholds of the
  barrier schedule;
* ``expected_cum``              — the inclusive prefix sum, the thresholds
  of the windowed schedule (ejections are cumulative across overlapped
  phases, so phase ``p`` counts as complete once *total* deliveries reach
  ``expected_cum[p]``);
* ``schedule`` / ``window``     — the dependency mode.  ``barrier``
  replays the host loop exactly (fresh per-phase state); ``window=W``
  lets every endpoint run up to ``W`` phases ahead of the
  globally-completed phase count (pipelined rounds).

Two compilations of the same program always conserve total packets:
``expected_cum[-1]`` is schedule-independent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ir import WorkloadProgram
from .patterns import check_schedule

__all__ = ["CompiledProgram", "compile_program"]

_INT32_MAX = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """Host-tensor form of a :class:`WorkloadProgram` plus its schedule."""

    name: str
    partner: torch.Tensor       # [n_phases, S] int32
    packets: torch.Tensor       # [n_phases, S] int32
    expected: torch.Tensor      # [n_phases]    int32
    expected_cum: torch.Tensor  # [n_phases]    int32
    n_phases: int
    n_endpoints: int
    schedule: str               # "barrier" | "window"
    window: int

    @property
    def total_packets(self) -> int:
        """Schedule-independent total (the conservation invariant)."""
        return int(self.expected_cum[-1])


def compile_program(program: WorkloadProgram, *, schedule: str = "barrier",
                    window: int = 1) -> CompiledProgram:
    """Lower ``program`` to int32 host tensors under a dependency
    schedule."""
    check_schedule(schedule, window)
    if not schedule:
        schedule = "barrier"
    program.validate()
    expected = program.expected()                       # int64 [n_phases]
    cum = np.cumsum(expected)
    if int(cum[-1]) > _INT32_MAX:
        raise ValueError(
            f"program total of {int(cum[-1])} packets overflows the int32 "
            "ejection counter")

    def i32(a):     # a copy: the program's own arrays stay its own
        return torch.tensor(np.asarray(a, np.int32))

    return CompiledProgram(
        name=program.name,
        partner=i32(program.partner),
        packets=i32(program.packets),
        expected=i32(expected),
        expected_cum=i32(cum),
        n_phases=program.n_phases,
        n_endpoints=program.n_endpoints,
        schedule=schedule,
        window=window if schedule == "window" else 1,
    )
