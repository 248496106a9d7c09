"""Declarative workload programs: a collective/traffic IR, its compiler,
and the shared pattern registry — the port's own copies of the
reference's ``repro.workloads``, with the compiled arrays as int32 torch
tensors.

* **IR** — :class:`WorkloadProgram`: ``[n_phases, S]`` per-endpoint
  ``partner`` / ``packets`` arrays, execution-agnostic.
* **Compiler** — :func:`compile_program` lowers a program plus a
  dependency schedule (``barrier`` or ``window=W``) to the arrays the
  engine's phase scheduler consumes (:class:`CompiledProgram`).
* **Library** — :mod:`repro_torch.workloads.programs` builds the
  standard collectives (shifted-exchange all2all, Rabenseifner / ring /
  recursive-doubling allreduce); :mod:`repro_torch.workloads.patterns`
  is the pattern-name registry shared by ``WorkloadSpec`` and the
  engine.

This package never imports the engine: programs are compiled to plain
tensors and handed to ``Simulator.run_program``.
"""
from .compile import CompiledProgram, compile_program
from .ir import WorkloadProgram
from .patterns import (ARRIVAL_PATTERNS, BERNOULLI_PATTERNS,
                       COLLECTIVE_PATTERNS, ENGINE_PATTERNS, SCHEDULES,
                       check_arrival, check_engine_pattern, check_pattern,
                       check_schedule, pattern_kinds, register_pattern)
from .programs import (PROGRAM_BUILDERS, all2all_program,
                       build_collective_program, rabenseifner_program,
                       rd_allreduce_program, register_program_builder,
                       ring_allreduce_program)

__all__ = [
    "WorkloadProgram", "CompiledProgram", "compile_program",
    "ARRIVAL_PATTERNS", "BERNOULLI_PATTERNS", "COLLECTIVE_PATTERNS",
    "ENGINE_PATTERNS", "SCHEDULES", "check_arrival", "check_engine_pattern",
    "check_pattern", "check_schedule", "pattern_kinds", "register_pattern",
    "PROGRAM_BUILDERS", "register_program_builder",
    "build_collective_program",
    "all2all_program", "rabenseifner_program", "ring_allreduce_program",
    "rd_allreduce_program",
]
