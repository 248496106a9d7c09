"""Declarative experiment layer of the port::

    from repro_torch.api import Experiment, NetworkSpec, WorkloadSpec, run

    result = run(Experiment(
        network=NetworkSpec("mrls", {"n_leaves": 62, "u": 6, "d": 6,
                                     "seed": 1}),
        workload=WorkloadSpec("uniform", load=1.0)))

``python -m repro_torch.api run spec.json`` runs a spec file.
"""
from .specs import Experiment, NetworkSpec, RouteSpec, WorkloadSpec
from .registry import build_network, topology_families
from .runner import Result, run

__all__ = ["Experiment", "NetworkSpec", "RouteSpec", "WorkloadSpec",
           "build_network", "topology_families", "Result", "run"]
