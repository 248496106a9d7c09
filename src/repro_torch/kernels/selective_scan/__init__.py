"""Mamba-1 selective scan: the CUDA kernels (the scan and its gradient),
their plain versions, and the op that picks them by device."""
from .ops import SelectiveScanFn, selective_scan_op
from .ref import selective_scan_bwd_ref, selective_scan_ref, state_sum

__all__ = ["SelectiveScanFn", "selective_scan_op", "selective_scan_ref",
           "selective_scan_bwd_ref", "state_sum"]
