"""Topologies and routing tables (numpy, computed on the host)."""
from .topology import Topology, mrls
from .routing import (bfs_distances, RoutingTables, build_tables,
                      pack_port_masks, iter_port_mask_blocks,
                      mask_table_bytes, MASK_LAYOUTS, DENSE_MASK_LIMIT)

# topology-family names the spec layer resolves NetworkSpec.family against
TOPOLOGY_FAMILIES = {"mrls": mrls}

__all__ = ["Topology", "mrls", "bfs_distances", "RoutingTables",
           "build_tables", "pack_port_masks", "iter_port_mask_blocks",
           "mask_table_bytes", "MASK_LAYOUTS", "DENSE_MASK_LIMIT",
           "TOPOLOGY_FAMILIES"]
