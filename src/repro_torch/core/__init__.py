"""Topologies (numpy on the host) and routing tables (int16 distance
rows, computed and kept on the card when the caller passes a CUDA
device)."""
from .topology import Topology, dragonfly, dragonfly_plus, fat_tree, mrls
from .routing import (bfs_distances, minplus_distances, RoutingTables,
                      build_tables)

# topology-family names the spec layer resolves NetworkSpec.family against
TOPOLOGY_FAMILIES = {"mrls": mrls, "fat_tree": fat_tree,
                     "dragonfly": dragonfly,
                     "dragonfly_plus": dragonfly_plus}

__all__ = ["Topology", "mrls", "fat_tree", "dragonfly", "dragonfly_plus",
           "bfs_distances", "minplus_distances", "RoutingTables",
           "build_tables", "TOPOLOGY_FAMILIES"]
