"""Crossbar arbitration: CUDA kernels, their plain versions, and the ops
that pick one by device."""
from .ops import (switch_arbitrate, switch_arbitrate_flat,
                  switch_arbitrate_rows, vc_prearb)
from .ref import (switch_arbitrate_ref, switch_arbitrate_rows_ref,
                  vc_prearb_ref)

__all__ = ["vc_prearb", "switch_arbitrate", "switch_arbitrate_flat",
           "switch_arbitrate_rows", "vc_prearb_ref", "switch_arbitrate_ref",
           "switch_arbitrate_rows_ref"]
