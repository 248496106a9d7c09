"""Step builders and abstract inputs for every (arch x shape) cell.

The port of the reference's ``launch/steps.py``.  ``make_train_step``
returns the training step (forward, backward through ``torch.autograd``,
clipping and the AdamW update); ``make_prefill_step`` /
``make_decode_step`` are the serving entry points; each takes the
sharder of a model laid out over ranks (``sh``, None on one device).
``input_structs`` gives the step's inputs as ``meta`` tensors (shapes
and dtypes, no storage; DTensors placed on the sharder's mesh), as the
reference gives ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ShapeCell
from ..models import model as M
from ..models.common import abstract_params, meta_tensor, trainable
from ..optim.adamw import (AdamWConfig, adamw_update, opt_specs,
                           tree_leaves)

__all__ = ["default_opt", "grads_and_loss", "make_train_step",
           "make_prefill_step", "make_decode_step", "input_structs"]


def default_opt(cfg: M.ModelConfig) -> AdamWConfig:
    """bf16 moments above 100 B parameters, else float32."""
    big = cfg.param_count() > 100e9
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def _nest_like(tree, flat: list):
    """``flat`` (in sorted-key leaf order) in the layout of ``tree``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def grads_and_loss(params: dict, batch: dict, cfg: M.ModelConfig,
                   sh=None):
    """(loss, grads): the float32 loss of ``batch`` and the gradient of
    every leaf of ``params`` (zeros where a leaf does not reach the loss,
    as the reference's), each in its leaf's dtype.  ``sh``: the sharder
    of a model laid out over ranks (``models.model.loss_fn``'s)."""
    leaves = trainable(params)
    loss = M.loss_fn(leaves, batch, cfg, sh)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.detach(), _nest_like(leaves, list(grads))


def make_train_step(cfg: M.ModelConfig, opt: AdamWConfig, sh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``."""
    def train_step(params, opt_state, batch):
        loss, grads = grads_and_loss(params, batch, cfg, sh)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: M.ModelConfig, sh=None):
    def prefill_step(params, batch):
        return M.prefill(params, batch["tokens"], cfg, batch.get("ctx"), sh)
    return prefill_step


def make_decode_step(cfg: M.ModelConfig, sh=None):
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg, sh)
    return decode_step


# ---------------------------------------------------------------------- #
# abstract inputs
# ---------------------------------------------------------------------- #
def _meta(shape, dtype, axes=None, sh=None) -> torch.Tensor:
    """A ``meta`` tensor; with a sharder, placed by the logical ``axes``
    (an axis that does not divide its dim dropped)."""
    placement = None if sh is None else sh.sharding(axes, shape)
    return meta_tensor(shape, dtype, placement, sh)


def _cache_struct(cfg: M.ModelConfig, batch: int, seq: int, sh=None) -> dict:
    """The decode cache at context length ``seq`` as ``meta`` tensors
    (the reference's ``cache_struct``, placed by its axes)."""
    bf16, f32 = torch.bfloat16, torch.float32
    di = cfg.ssm_expand * cfg.d_model
    kv = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    ctx = (batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)
    kv_ax = ("dp", "tp", None, None)
    ctx_ax = ("dp", None, None, None)
    ssm_ax = ("dp", "tp", None)
    ssm = {"conv": ((batch, di, cfg.ssm_conv - 1), bf16, ssm_ax),
           "ssm": ((batch, di, cfg.ssm_state), f32, ssm_ax)}
    out = {}
    for g in M.plan(cfg)[1:] if cfg.enc_dec else M.plan(cfg):
        if g.kind == "mamba":
            c = dict(ssm)
        elif g.kind in ("hybrid", "hybrid_full"):
            W = cfg.sliding_window if g.kind == "hybrid" else seq
            w = (batch, W, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": (w, bf16, kv_ax), "v": (w, bf16, kv_ax), **ssm}
        elif g.kind.startswith("mla"):
            ax = ("dp", "tp", None)
            c = {"ckv": ((batch, seq, cfg.mla.kv_lora), bf16, ax),
                 "kr": ((batch, seq, cfg.mla.rope_dim), bf16, ax)}
        elif g.kind == "vision_super":
            ns = cfg.cross_every - 1
            c = {"k": ((ns, *kv), bf16, (None, *kv_ax)),
                 "v": ((ns, *kv), bf16, (None, *kv_ax)),
                 "ck": (ctx, bf16, ctx_ax), "cv": (ctx, bf16, ctx_ax)}
        elif g.kind == "dec":
            c = {"k": (kv, bf16, kv_ax), "v": (kv, bf16, kv_ax),
                 "ck": (ctx, bf16, ctx_ax), "cv": (ctx, bf16, ctx_ax)}
        else:
            w = (batch, cfg.sliding_window or seq, cfg.n_kv_heads,
                 cfg.head_dim)
            c = {"k": (w, bf16, kv_ax), "v": (w, bf16, kv_ax)}
        out[g.name] = {k: _meta((g.n, *shape), dt, (None, *ax), sh)
                       for k, (shape, dt, ax) in c.items()}
    return out


def input_structs(cfg: M.ModelConfig, cell: ShapeCell,
                  opt: Optional[AdamWConfig] = None, sh=None) -> dict:
    """Abstract inputs for the cell's step function, as ``meta``
    tensors:

    train   -> {params, opt_state, batch}
    prefill -> {params, batch}
    decode  -> {params, cache, tokens, pos}

    With a sharder that has a ``DeviceMesh``, every input is a meta
    DTensor placed as the reference places it: parameters and moments by
    their specs' axes, tokens and labels over ``dp``, the context over
    ``dp``, the cache as the reference's ``cache_struct``.
    """
    specs = M.build_specs(cfg)
    out = {"params": abstract_params(specs, sh)}
    B, S = cell.batch, cell.seq
    batch = {"tokens": _meta((B, S), torch.int32, ("dp", None), sh)}
    if cell.kind in ("train", "prefill") and cfg.n_ctx_tokens:
        batch["ctx"] = _meta((B, cfg.n_ctx_tokens, cfg.d_model),
                             torch.bfloat16, ("dp", None, None), sh)
    if cell.kind == "train":
        out["opt_state"] = abstract_params(
            opt_specs(specs, opt or default_opt(cfg)), sh)
        batch["labels"] = _meta((B, S), torch.int32, ("dp", None), sh)
        out["batch"] = batch
    elif cell.kind == "prefill":
        out["batch"] = batch
    else:
        out["cache"] = _cache_struct(cfg, B, S, sh)
        out["tokens"] = _meta((B, 1), torch.int32, ("dp", None), sh)
        out["pos"] = _meta((), torch.int32, (), sh)
    return out
