"""Topologies (numpy on the host), routing tables (int16 distance rows,
computed and kept on the card when the caller passes a CUDA device), the
paper's analytic metrics and the collectives' phase lists."""
from .topology import (Topology, dragonfly, dragonfly_plus, fat_tree,
                       jellyfish, mrls, oft, rfc)
from .routing import (bfs_distances, minplus_distances, RoutingTables,
                      build_tables)
from .analytics import (Metrics, exact_metrics, theta, cost_links,
                        cost_switches, mrls_distance_distribution,
                        mrls_expected_A, mrls_expected_A_star,
                        prob_dstar_leq, dstar_thresholds, mrls_design)
from .collectives import (all2all_rounds, rabenseifner_phases,
                          ring_allreduce_phases, recursive_doubling_phases,
                          all2all_lower_bound_slots,
                          allreduce_lower_bound_slots)

# topology-family names the spec layer resolves NetworkSpec.family against
TOPOLOGY_FAMILIES = {"mrls": mrls, "fat_tree": fat_tree, "oft": oft,
                     "dragonfly": dragonfly,
                     "dragonfly_plus": dragonfly_plus, "rfc": rfc,
                     "jellyfish": jellyfish}

__all__ = ["Topology", "mrls", "fat_tree", "oft", "dragonfly",
           "dragonfly_plus", "rfc", "jellyfish", "bfs_distances",
           "minplus_distances", "RoutingTables", "build_tables", "Metrics",
           "exact_metrics", "theta", "cost_links", "cost_switches",
           "mrls_distance_distribution", "mrls_expected_A",
           "mrls_expected_A_star", "prob_dstar_leq", "dstar_thresholds",
           "mrls_design", "all2all_rounds", "rabenseifner_phases",
           "ring_allreduce_phases", "recursive_doubling_phases",
           "all2all_lower_bound_slots", "allreduce_lower_bound_slots",
           "TOPOLOGY_FAMILIES"]
