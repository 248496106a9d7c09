"""Carry simulator state between the reference engine and the port.

The reference's state, fetched to the host (``jax.device_get``), is a
dict of numpy arrays; :func:`state_from_jax` turns it into the port's
state on a device, so a run can continue in the port from a state the
reference reached.  :func:`state_to_numpy` goes the other way and gives
exactly the reference's arrays: the PRNG key as uint32 and the pool
tensors without their pad slot.  The routing tables need no conversion:
both packages build them from the same numpy code.
"""
from __future__ import annotations

import numpy as np
import torch

from .simulator.engine import POOL_KEYS

__all__ = ["state_from_jax", "state_to_numpy"]


def state_from_jax(np_state: dict, device) -> dict:
    """The port's state from the reference's state as numpy arrays."""
    st = {}
    for k, v in np_state.items():
        a = np.asarray(v)
        if k == "key":
            a = a.astype(np.uint32).view(np.int32)
        elif k in POOL_KEYS:
            a = np.concatenate([a, np.asarray([POOL_KEYS[k]], a.dtype)])
        st[k] = torch.as_tensor(np.array(a, copy=True), device=device)
    return st


def state_to_numpy(st: dict) -> dict:
    """The reference's numpy state from the port's state."""
    out = {}
    for k, v in st.items():
        a = v.detach().cpu().numpy()
        if k == "key":
            a = a.view(np.uint32)
        elif k in POOL_KEYS:
            a = a[:-1]
        out[k] = a
    return out
