"""Mamba-1 selective scan: the CUDA kernel, its plain version, and the op
that picks one by device."""
from .ops import selective_scan_op
from .ref import selective_scan_ref, state_sum

__all__ = ["selective_scan_op", "selective_scan_ref", "state_sum"]
