"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Registered: the architectures the port runs (``hymba-1.5b``,
``falcon-mamba-7b``) and the config records that the serving bridge
reads (``qwen3-1.7b``, ``qwen3-moe-235b-a22b``), whose models raise when
built and name the ROADMAP item that ports them.  Every other arch of
the reference's registry raises here and names that item.
``reduced(cfg)`` gives the reference's tiny config of the same family for
CPU tests (few layers, narrow width, tiny vocab).
"""
from __future__ import annotations

import dataclasses

from ..models.model import ModelConfig
from ..models.moe import MoECfg
from . import falcon_mamba_7b, hymba_1_5b, qwen3_1_7b, qwen3_moe_235b_a22b

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (hymba_1_5b, qwen3_1_7b, qwen3_moe_235b_a22b, falcon_mamba_7b)}

ARCHS = tuple(REGISTRY)

# archs of the reference's registry that the port does not run yet
_NOT_PORTED = ("nemotron-4-15b", "starcoder2-15b", "command-r-plus-104b",
               "deepseek-v3-671b", "llama-3.2-vision-90b",
               "seamless-m4t-medium")


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP queue 1 item 13); "
            f"registered: {sorted(REGISTRY)}")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The reference's ``reduced``, for the fields the port has: 4
    layers, width 128, 4 query heads on 2 KV heads of 32, d_ff 256, vocab
    512; a hybrid takes 5 heads on 1 of 16 (TP over the head dim) and a
    32-key window with full attention in layers 0 and 3; an MoE 8
    experts, top 2, of width 64."""
    kw: dict = dict(
        name=cfg.name + "-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
        sliding_window=32 if cfg.sliding_window else None,
        full_attn_layers=(0, 3) if cfg.full_attn_layers else ())
    if cfg.hybrid:
        kw.update(n_heads=5, n_kv_heads=1, head_dim=16, tp_heads=False)
    if cfg.moe is not None:
        kw["moe"] = MoECfg(n_experts=8, top_k=2, d_expert=64,
                           n_shared=cfg.moe.n_shared,
                           router_scale_bias=cfg.moe.router_scale_bias)
    return dataclasses.replace(cfg, **kw)


__all__ = ["REGISTRY", "ARCHS", "get_config", "reduced"]
