"""Tropical (min, +) matrix product: the CUDA kernel, its plain version,
and the ops that pick one by device."""
from .ops import INF, all_pairs_distances, minplus_op
from .ref import adjacency_matrix, all_pairs_ref, minplus_powers, minplus_ref

__all__ = ["INF", "minplus_op", "all_pairs_distances", "minplus_ref",
           "adjacency_matrix", "minplus_powers", "all_pairs_ref"]
