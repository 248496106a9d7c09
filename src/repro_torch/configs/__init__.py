"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus shape cells.

Registered: every architecture of the reference's registry — the hybrid
``hymba-1.5b``, the attention-free ``falcon-mamba-7b``, the dense
``qwen3-1.7b``, ``nemotron-4-15b``, ``starcoder2-15b`` and
``command-r-plus-104b``, the MoE ``qwen3-moe-235b-a22b`` and
``deepseek-v3-671b`` (MLA), the vision model ``llama-3.2-vision-90b``
(gated cross-attention to vision tokens) and the encoder-decoder
``seamless-m4t-medium`` (audio frames).
``reduced(cfg)`` gives the reference's tiny config of the same family for
CPU tests (few layers, narrow width, tiny vocab, few experts, few
context tokens).
"""
from __future__ import annotations

import dataclasses

from ..models.model import MLACfg, ModelConfig
from ..models.moe import MoECfg
from .base import SHAPES, ShapeCell, supports
from . import (command_r_plus_104b, deepseek_v3_671b, falcon_mamba_7b,
               hymba_1_5b, llama_3_2_vision_90b, nemotron_4_15b, qwen3_1_7b,
               qwen3_moe_235b_a22b, seamless_m4t_medium, starcoder2_15b)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (nemotron_4_15b, qwen3_1_7b, starcoder2_15b,
              command_r_plus_104b, hymba_1_5b, qwen3_moe_235b_a22b,
              deepseek_v3_671b, llama_3_2_vision_90b, seamless_m4t_medium,
              falcon_mamba_7b)}

ARCHS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's ``reduced``, for the fields the port has: 4
    layers, width 128, 4 query heads on 2 KV heads of 32, d_ff 256 (and
    ``dense_d_ff`` 256, at most one leading dense layer), vocab 512; a
    hybrid takes 5 heads on 1 of 16 (TP over the head dim) and a 32-key
    window with full attention in layers 0 and 3; an MoE 8 experts, top
    2, of width 64; an MLA model ``MLACfg(64, 32, 32, 16, 32)`` and 4
    heads on 4 KV heads of 32; a model with context tokens 16 of them, a
    vision model super-blocks of 2 (2 of 1 self + 1 cross layer), an
    encoder-decoder 2 encoder layers."""
    kw: dict = dict(
        name=cfg.name + "-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512, dense_d_ff=256,
        n_ctx_tokens=16 if cfg.n_ctx_tokens else 0,
        enc_layers=2 if cfg.enc_dec else 0,
        sliding_window=32 if cfg.sliding_window else None,
        full_attn_layers=(0, 3) if cfg.full_attn_layers else (),
        cross_every=cfg.cross_every and 2,
        dense_layers=min(cfg.dense_layers, 1))
    if cfg.hybrid:
        kw.update(n_heads=5, n_kv_heads=1, head_dim=16, tp_heads=False)
    if cfg.moe is not None:
        kw["moe"] = MoECfg(n_experts=8, top_k=2, d_expert=64,
                           n_shared=cfg.moe.n_shared,
                           router_scale_bias=cfg.moe.router_scale_bias)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(q_lora=64, kv_lora=32, nope_dim=32, rope_dim=16,
                           v_dim=32)
        kw.update(n_heads=4, n_kv_heads=4, head_dim=32)
    return dataclasses.replace(cfg, **kw)


__all__ = ["REGISTRY", "ARCHS", "get_config", "reduced", "SHAPES",
           "ShapeCell", "supports"]
