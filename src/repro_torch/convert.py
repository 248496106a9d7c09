"""Carry simulator state and model weights between the reference and the port.

The reference's state, fetched to the host (``jax.device_get``), is a
dict of numpy arrays; :func:`state_from_jax` turns it into the port's
state on a device, so a run can continue in the port from a state the
reference reached.  :func:`state_to_numpy` goes the other way and gives
exactly the reference's arrays: the PRNG keys (``key``, and a program
state's ``key0``) and an armed state's mask words (``tbl_min``,
``tbl_away``) as uint32 and the pool tensors without their pad slot.
Both take batched states too (a leading replica axis, as the
reference's ``make_batch_state`` stacks them): the pad slot is on the
last axis, and a program's shared arrays (``PROG_SHARED``) stay
unbatched, in both packages.  The routing tables need no conversion:
both packages build them from the same numpy code.

:func:`params_from_jax` turns the reference model's parameter tree, as
numpy arrays (each group stacked over its layers; a vision super-block's
``self`` leaves stacked twice, its float32 gates one scalar a layer; an
encoder-decoder's ``enc_final_norm``), into the port's;
:func:`opt_state_from_jax` does the same for the reference's AdamW state
(``m`` and ``v`` in the parameters' layout, of its state dtype, and the
int32 ``step``), so that both packages start a step from one state; and
:func:`cache_to_numpy` gives a decode cache back as numpy arrays (the
cross layers' ``ck`` / ``cv`` beside the ``k`` / ``v`` entries).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import flatten_specs
from .models.model import build_specs
from .optim.adamw import AdamWConfig, opt_specs
from .simulator.engine import KEY_KEYS, MASK_KEYS, POOL_KEYS

__all__ = ["state_from_jax", "state_to_numpy", "params_from_jax",
           "opt_state_from_jax", "cache_to_numpy"]


def state_from_jax(np_state: dict, device) -> dict:
    """The port's state from the reference's state as numpy arrays."""
    st = {}
    for k, v in np_state.items():
        a = np.asarray(v)
        if k in KEY_KEYS or k in MASK_KEYS:
            a = a.astype(np.uint32).view(np.int32)
        elif k in POOL_KEYS:
            pad = np.full(a.shape[:-1] + (1,), POOL_KEYS[k], a.dtype)
            a = np.concatenate([a, pad], axis=-1)
        st[k] = torch.as_tensor(np.array(a, copy=True), device=device)
    return st


def state_to_numpy(st: dict) -> dict:
    """The reference's numpy state from the port's state."""
    out = {}
    for k, v in st.items():
        a = v.detach().cpu().numpy()
        if k in KEY_KEYS or k in MASK_KEYS:
            a = a.view(np.uint32)
        elif k in POOL_KEYS:
            a = a[..., :-1]
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
    return _tree_from_jax(np_params, build_specs(cfg), device)


def opt_state_from_jax(np_opt: dict, cfg, device) -> dict:
    """The port's AdamW state from the reference's (``{"m", "v",
    "step"}`` as numpy arrays): every leaf of the parameters' specs in
    ``m`` and ``v``, all of one state dtype (float32 or bfloat16), and
    ``step`` an int32 scalar."""
    sd = np.asarray(flatten_specs(np_opt["m"])[0][1]).dtype.name
    return _tree_from_jax(np_opt, opt_specs(build_specs(cfg),
                                            AdamWConfig(state_dtype=sd)),
                          device)


def _tree_from_jax(np_tree: dict, specs: dict, device) -> dict:
    """Each leaf of ``specs`` taken from ``np_tree``, checked against the
    spec's shape and dtype."""
    out: dict = {}
    for path, spec in flatten_specs(specs):
        node, src = out, np_tree
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
