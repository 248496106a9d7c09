"""AdamW with global-norm clipping and schedules.

The port of the reference's ``optim/adamw.py`` as plain functions on the
port's parameter trees (nested dicts of tensors).  The optimizer state
``{"m", "v", "step"}`` mirrors the parameter tree: moments of
``state_dtype`` (float32 by default; bf16 halves them, as the reference
takes it above 100 B parameters), ``step`` an int32 scalar tensor.

The update runs in float32 and keeps the reference's order of
operations (``b1 * m + (1 - b1) * g``, then ``/ bc1``, ...), each a
separate rounding, so that on the CPU it gives the reference's bits
where the operations are IEEE-exact; no weight decay on leaves of fewer
than 2 dims (norms, biases); gradients clipped by ``clip_norm / (gnorm +
1e-9)``.  It runs under ``torch.no_grad()`` and returns new tensors: the
parameters and moments passed in are left as they are.  A division by a
scalar divides by a tensor on the operands' device, since CUDA
multiplies by the reciprocal of a host scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..models.common import ParamSpec

__all__ = ["AdamWConfig", "opt_specs", "init_opt", "adamw_update",
           "warmup_cosine", "global_norm", "tree_leaves", "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    schedule: Optional[Callable] = None     # step -> lr multiplier


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level (a JAX
    pytree's leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on ``x``'s device."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    """The lr multiplier of an int32 step tensor: linear from 0 over
    ``warmup`` steps, then a cosine down to ``floor`` at ``total``."""
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = _div(step, max(warmup, 1))
        t = torch.clamp(_div(step - warmup, max(total - warmup, 1)),
                        0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return f


def opt_specs(param_specs, cfg: AdamWConfig) -> dict:
    """The spec tree of ``{"m", "v", "step"}``: the parameters' shapes
    and axes in ``state_dtype``, zeros; ``step`` an int32 scalar."""
    def conv(s):
        if isinstance(s, dict):
            return {k: conv(v) for k, v in s.items()}
        return ParamSpec(tuple(s.shape), cfg.state_dtype, "zeros",
                         axes=s.axes)
    tree = conv(param_specs)
    return {"m": tree, "v": tree,
            "step": ParamSpec((), "int32", "zeros", axes=())}


def init_opt(param_specs, cfg: AdamWConfig, device=None) -> dict:
    """The optimizer state of ``param_specs``, zeros on ``device``
    (default: the card)."""
    dev = resolve_device(device)

    def zeros(s):
        if isinstance(s, dict):
            return {k: zeros(v) for k, v in s.items()}
        return torch.zeros(tuple(s.shape), dtype=_DTYPES[s.dtype],
                           device=dev)
    return zeros(opt_specs(param_specs, cfg))


def global_norm(tree) -> torch.Tensor:
    """float32 ``sqrt`` of the sum of every leaf's sum of squares, the
    leaves in sorted-key order."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics): ``metrics`` holds
    ``grad_norm`` (before clipping) and ``lr`` as float32 scalar
    tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule else
                   torch.tensor(1.0, dtype=torch.float32, device=dev))
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev),
                        stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev),
                        stepf)
    sd = _DTYPES[cfg.state_dtype]

    def upd(p, g, m, v):
        gf = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * torch.square(gf)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:                      # no decay on norms/biases
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), mf.to(sd), vf.to(sd)

    new = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return _pick(new, 0), \
        {"m": _pick(new, 1), "v": _pick(new, 2), "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    """The ``i``-th member of each tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
