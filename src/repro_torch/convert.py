"""Carry simulator state and model weights between the reference and the port.

The reference's state, fetched to the host (``jax.device_get``), is a
dict of numpy arrays; :func:`state_from_jax` turns it into the port's
state on a device, so a run can continue in the port from a state the
reference reached.  :func:`state_to_numpy` goes the other way and gives
exactly the reference's arrays: the PRNG keys (``key``, and a program
state's ``key0``) as uint32 and the pool tensors without their pad slot.  The routing tables need no conversion:
both packages build them from the same numpy code.

:func:`params_from_jax` turns the reference model's parameter tree, as
numpy arrays (each group stacked over its layers), into the port's, and
:func:`cache_to_numpy` gives a decode cache back as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import flatten_specs
from .models.model import build_specs
from .simulator.engine import KEY_KEYS, POOL_KEYS

__all__ = ["state_from_jax", "state_to_numpy", "params_from_jax",
           "cache_to_numpy"]


def state_from_jax(np_state: dict, device) -> dict:
    """The port's state from the reference's state as numpy arrays."""
    st = {}
    for k, v in np_state.items():
        a = np.asarray(v)
        if k in KEY_KEYS:
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
        if k in KEY_KEYS:
            a = a.view(np.uint32)
        elif k in POOL_KEYS:
            a = a[:-1]
        out[k] = a
    return out


def _leaf_to_torch(a, device) -> torch.Tensor:
    """A numpy array, bfloat16 (``ml_dtypes``) included, as a tensor of
    the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_params: dict, cfg, device) -> dict:
    """The port's parameters from the reference's parameter tree as numpy
    arrays (``jax.device_get`` of ``init_params``' tree).  Every leaf of
    ``build_specs(cfg)`` must be there with its shape and dtype."""
    out: dict = {}
    for path, spec in flatten_specs(build_specs(cfg)):
        node, src = out, np_params
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
            src = src[k]
        a = np.asarray(src[leaf])
        if tuple(a.shape) != tuple(spec.shape) or a.dtype.name != spec.dtype:
            raise ValueError(f"{path}: got {a.dtype.name}{list(a.shape)}, "
                             f"expected {spec.dtype}{list(spec.shape)}")
        node[leaf] = _leaf_to_torch(a, device)
    return out


def cache_to_numpy(cache: dict) -> dict:
    """A decode cache as numpy arrays in the reference's layout; bf16
    entries come back as float32, which holds their values exactly."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    t = cache.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
