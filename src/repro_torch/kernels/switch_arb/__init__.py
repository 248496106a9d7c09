"""Crossbar arbitration: CUDA kernels, their plain versions, and the ops
that pick one by device."""
from .ops import switch_arbitrate, switch_arbitrate_flat, vc_prearb
from .ref import switch_arbitrate_ref, vc_prearb_ref

__all__ = ["vc_prearb", "switch_arbitrate", "switch_arbitrate_flat",
           "vc_prearb_ref", "switch_arbitrate_ref"]
