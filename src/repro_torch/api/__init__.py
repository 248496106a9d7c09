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
and ``resume``) continues after a kill, bitwise.
"""
from .specs import Experiment, NetworkSpec, RouteSpec, WorkloadSpec
from .registry import build_network, topology_families, workload_patterns
from .runner import Result, SimulatorCache, open_simulator, run, run_all
from .resume import resume, run_resumable
from .sweep import expand_axes, sweep
from .degrade import DegradeSpec, degrade_sweep, degrade_sweep_many
from ..core.failures import FailureEvent, FailureSchedule

__all__ = ["Experiment", "NetworkSpec", "RouteSpec", "WorkloadSpec",
           "build_network", "topology_families", "workload_patterns",
           "Result", "SimulatorCache", "open_simulator", "run", "run_all",
           "resume", "run_resumable",
           "expand_axes", "sweep", "DegradeSpec", "degrade_sweep",
           "degrade_sweep_many", "FailureEvent", "FailureSchedule"]
