"""Design-space search over (family, radix, f, policy, vcs).

The port's ``repro.search``: a frozen :class:`SearchSpec` names the axes
and protocol, :func:`search` samples, prunes (the reference's spec-level
``estimate_memory`` against ``mem_budget_mib``, then the port's device
admission gate), screens and promotes candidates through the port's
``run`` on the caller's device, and the Pareto layer marks the
throughput-vs-cost frontier.  ``python -m repro_torch.api search`` runs
a spec file (:mod:`repro_torch.search.cli`).
"""
from .loop import search, search_many
from .pareto import dominated_flags, frontier_ids
from .space import (Candidate, DesignError, axis_values,
                    candidate_experiment, design_network, designer_families,
                    register_designer, space_size)
from .spec import OBJECTIVES, STRATEGIES, SearchSpec

__all__ = [
    "SearchSpec", "OBJECTIVES", "STRATEGIES",
    "Candidate", "DesignError", "register_designer", "designer_families",
    "design_network", "candidate_experiment", "axis_values", "space_size",
    "search", "search_many",
    "dominated_flags", "frontier_ids",
]
