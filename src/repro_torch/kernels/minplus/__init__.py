"""Tropical (min, +) matrix product: the CUDA kernels (float32, and int16
hop counts on Hopper's DPX instructions), their plain versions, and the
ops that pick one by device."""
from .ops import INF, all_pairs_distances, minplus_hops_op, minplus_op
from .ref import (HOPS_INF, HOPS_LIMIT, adjacency_matrix, all_pairs_ref,
                  hops_adjacency, minplus_hops_ref, minplus_powers,
                  minplus_ref, padded_hops)

__all__ = ["INF", "minplus_op", "all_pairs_distances", "minplus_ref",
           "adjacency_matrix", "minplus_powers", "all_pairs_ref",
           "HOPS_INF", "HOPS_LIMIT", "minplus_hops_op", "minplus_hops_ref",
           "padded_hops", "hops_adjacency"]
