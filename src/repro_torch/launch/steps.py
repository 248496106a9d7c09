"""Step builders and abstract inputs for every (arch x shape) cell.

The port of the reference's ``launch/steps.py``.  ``make_train_step``
returns the training step (forward, backward through ``torch.autograd``,
clipping and the AdamW update); ``make_prefill_step`` /
``make_decode_step`` are the serving entry points.  ``input_structs``
gives the step's inputs as ``meta`` tensors (shapes and dtypes, no
storage), as the reference gives ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ShapeCell
from ..models import model as M
from ..models.common import abstract_params, trainable
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


def grads_and_loss(params: dict, batch: dict, cfg: M.ModelConfig):
    """(loss, grads): the float32 loss of ``batch`` and the gradient of
    every leaf of ``params`` (zeros where a leaf does not reach the loss,
    as the reference's), each in its leaf's dtype."""
    leaves = trainable(params)
    loss = M.loss_fn(leaves, batch, cfg)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.detach(), _nest_like(leaves, list(grads))


def make_train_step(cfg: M.ModelConfig, opt: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``."""
    def train_step(params, opt_state, batch):
        loss, grads = grads_and_loss(params, batch, cfg)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(cfg: M.ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(params, batch["tokens"], cfg, batch.get("ctx"))
    return prefill_step


def make_decode_step(cfg: M.ModelConfig):
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg)
    return decode_step


# ---------------------------------------------------------------------- #
# abstract inputs
# ---------------------------------------------------------------------- #
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _cache_struct(cfg: M.ModelConfig, batch: int, seq: int) -> dict:
    """The decode cache at context length ``seq`` as ``meta`` tensors
    (the reference's ``cache_struct``)."""
    bf16, f32 = torch.bfloat16, torch.float32
    di = cfg.ssm_expand * cfg.d_model
    kv = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    ctx = (batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)
    ssm = {"conv": ((batch, di, cfg.ssm_conv - 1), bf16),
           "ssm": ((batch, di, cfg.ssm_state), f32)}
    out = {}
    for g in M.plan(cfg)[1:] if cfg.enc_dec else M.plan(cfg):
        if g.kind == "mamba":
            c = dict(ssm)
        elif g.kind in ("hybrid", "hybrid_full"):
            W = cfg.sliding_window if g.kind == "hybrid" else seq
            w = (batch, W, cfg.n_kv_heads, cfg.head_dim)
            c = {"k": (w, bf16), "v": (w, bf16), **ssm}
        elif g.kind.startswith("mla"):
            c = {"ckv": ((batch, seq, cfg.mla.kv_lora), bf16),
                 "kr": ((batch, seq, cfg.mla.rope_dim), bf16)}
        elif g.kind == "vision_super":
            ns = cfg.cross_every - 1
            c = {"k": ((ns, *kv), bf16), "v": ((ns, *kv), bf16),
                 "ck": (ctx, bf16), "cv": (ctx, bf16)}
        elif g.kind == "dec":
            c = {"k": (kv, bf16), "v": (kv, bf16), "ck": (ctx, bf16),
                 "cv": (ctx, bf16)}
        else:
            w = (batch, cfg.sliding_window or seq, cfg.n_kv_heads,
                 cfg.head_dim)
            c = {"k": (w, bf16), "v": (w, bf16)}
        out[g.name] = {k: _meta((g.n, *shape), dt)
                       for k, (shape, dt) in c.items()}
    return out


def input_structs(cfg: M.ModelConfig, cell: ShapeCell,
                  opt: Optional[AdamWConfig] = None) -> dict:
    """Abstract inputs for the cell's step function, as ``meta``
    tensors:

    train   -> {params, opt_state, batch}
    prefill -> {params, batch}
    decode  -> {params, cache, tokens, pos}
    """
    specs = M.build_specs(cfg)
    out = {"params": abstract_params(specs)}
    B, S = cell.batch, cell.seq
    batch = {"tokens": _meta((B, S), torch.int32)}
    if cell.kind in ("train", "prefill") and cfg.n_ctx_tokens:
        batch["ctx"] = _meta((B, cfg.n_ctx_tokens, cfg.d_model),
                             torch.bfloat16)
    if cell.kind == "train":
        out["opt_state"] = abstract_params(
            opt_specs(specs, opt or default_opt(cfg)))
        batch["labels"] = _meta((B, S), torch.int32)
        out["batch"] = batch
    elif cell.kind == "prefill":
        out["batch"] = batch
    else:
        out["cache"] = _cache_struct(cfg, B, S)
        out["tokens"] = _meta((B, 1), torch.int32)
        out["pos"] = _meta((), torch.int32)
    return out
