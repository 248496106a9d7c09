"""Declarative experiment layer of the port::

    from repro_torch.api import Experiment, NetworkSpec, WorkloadSpec, run

    result = run(Experiment(
        network=NetworkSpec("mrls", {"n_leaves": 62, "u": 6, "d": 6,
                                     "seed": 1}),
        workload=WorkloadSpec("uniform", load=1.0)))

``run_all`` and ``sweep`` share one simulator among the experiments of a
fabric (:class:`SimulatorCache`).  A ``NetworkSpec`` may carry a
:class:`FailureSchedule` (the ``resilience`` metric), and
:func:`degrade_sweep` runs a link-failure degradation curve.  ``python -m
repro_torch.api run spec.json`` runs a spec file; ``sweep``,
``serve-sweep``, ``degrade``, ``families`` and ``patterns`` are the
other subcommands.  :func:`run_resumable` runs an experiment in
checkpointed segments that :func:`resume` (the CLI's ``run --ckpt-dir``
and ``resume``) continues after a kill, bitwise.  :func:`estimate_memory`
is the reference's spec-level price of an experiment;
:func:`device_peak_bytes` the port's own byte model, which
:func:`check_admission` holds against the device's budget before every
run (the CLI's ``estimate`` prints both; ``search`` runs a design-space
search, :mod:`repro_torch.search`).
"""
from .specs import Experiment, NetworkSpec, RouteSpec, WorkloadSpec
from .registry import build_network, topology_families, workload_patterns
from .runner import Result, SimulatorCache, open_simulator, run, run_all
from .memory import estimate_memory, format_bytes
from .admission import (AdmissionDecision, AdmissionError, check_admission,
                        device_peak_bytes, host_ram_bytes)
from .resume import resume, run_resumable
from .sweep import expand_axes, sweep
from .degrade import DegradeSpec, degrade_sweep, degrade_sweep_many
from ..core.failures import FailureEvent, FailureSchedule

__all__ = ["Experiment", "NetworkSpec", "RouteSpec", "WorkloadSpec",
           "build_network", "topology_families", "workload_patterns",
           "Result", "SimulatorCache", "open_simulator", "run", "run_all",
           "estimate_memory", "format_bytes", "AdmissionDecision",
           "AdmissionError", "check_admission", "device_peak_bytes",
           "host_ram_bytes",
           "resume", "run_resumable",
           "expand_axes", "sweep", "DegradeSpec", "degrade_sweep",
           "degrade_sweep_many", "FailureEvent", "FailureSchedule"]
