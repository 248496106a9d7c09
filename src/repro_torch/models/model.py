"""Model assembly: configuration, block program, prefill and decode.

The port of the reference's ``models/model.py`` for the kinds it runs.
A model is a block program: an ordered list of homogeneous groups, each
with its parameters stacked over its layers (``params["groups"][name]``
holds ``[n, ...]`` tensors), so parameter trees and caches have the
reference's layout leaf for leaf.  The port walks each group's layers in
a Python loop where the reference scans.

Two entry points: :func:`prefill` builds the decode cache from a prompt
and :func:`decode_step` runs one token against it, updating the cache in
place (the reference returns a new cache).  Ported kinds: ``dense``
(GQA attention and an MLP: Qwen3, Nemotron, StarCoder2, Command R+),
``moe`` (GQA attention and the routed experts of ``models.moe``: the
Qwen3 MoE), ``mla_dense`` and ``mla_moe`` (MLA attention and an MLP or
the routed experts: DeepSeek-V3), ``hybrid`` and ``hybrid_full``
(Hymba) and the attention-free ``mamba`` (falcon-mamba).  Every other
kind raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention_op
from . import attention as attn
from .common import (ParamSpec, count_params, init_scale_out, mlp_apply,
                     mlp_specs, pad_vocab, proj, rmsnorm)
from .moe import MoECfg, moe_apply, moe_specs
from .ssm import ssm_decode, ssm_prefill, ssm_specs

__all__ = ["MLACfg", "ModelConfig", "Group", "plan", "block_specs",
           "build_specs", "embed", "logits_from", "block_apply",
           "block_decode", "prefill", "decode_step"]

_HYBRID = ("hybrid", "hybrid_full")
_MLA = ("mla_dense", "mla_moe")
_KINDS = ("dense", "moe") + _MLA + _HYBRID + ("mamba",)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kind!r} models are not ported yet (ROADMAP queue 1 item 13); the "
        f"port runs the block kinds {_KINDS}")


# ---------------------------------------------------------------------- #
# configuration: the reference's fields that the port reads
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tp_heads: bool = True           # TP over heads (False -> over head_dim)
    # MoE
    moe: Optional[MoECfg] = None
    dense_layers: int = 0           # leading dense layers
    dense_d_ff: int = 0
    # MLA
    mla: Optional[MLACfg] = None
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    hybrid: bool = False            # parallel attn + ssm (Hymba)
    full_attn_layers: tuple = ()    # hybrid: these layer idxs use full attn
    sliding_window: Optional[int] = None

    @property
    def total_layers(self) -> int:
        """Layers of the whole model (the reference adds an encoder's,
        which the port does not have)."""
        return self.n_layers

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid-with-window)."""
        return self.ssm_state > 0

    def param_count(self) -> int:
        return count_params(build_specs(self))


# ---------------------------------------------------------------------- #
# block program
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Group:
    kind: str
    n: int
    name: str


def plan(cfg: ModelConfig) -> list:
    """The groups of layers, in order (the reference's ``plan``): an SSM
    model is one group of ``mamba`` layers; a hybrid has runs of
    sliding-window layers between the full-attention layers, each
    full-attention layer a group of its own; an MoE model its leading
    ``dense`` layers, then its ``moe`` layers (``mla_dense`` and
    ``mla_moe`` where it has MLA); any other, one group of ``dense``
    layers."""
    if cfg.family in ("vlm", "audio"):
        raise _not_ported(cfg.family)
    if cfg.family == "ssm":
        return [Group("mamba", cfg.n_layers, "m")]
    if cfg.hybrid:
        groups, prev, gi = [], 0, 0
        for li in sorted(cfg.full_attn_layers):
            if li > prev:
                groups.append(Group("hybrid", li - prev, f"h{gi}"))
                gi += 1
            groups.append(Group("hybrid_full", 1, f"hf{gi}"))
            gi += 1
            prev = li + 1
        if prev < cfg.n_layers:
            groups.append(Group("hybrid", cfg.n_layers - prev, f"h{gi}"))
        return groups
    if cfg.moe is not None:
        pre = "mla_" if cfg.mla else ""
        groups = []
        if cfg.dense_layers:
            groups.append(Group(pre + "dense", cfg.dense_layers, "d"))
        groups.append(Group(pre + "moe", cfg.n_layers - cfg.dense_layers,
                            "e"))
        return groups
    return [Group("dense", cfg.n_layers, "d")]


def _norm(cfg) -> ParamSpec:
    return ParamSpec((cfg.d_model,), "float32", "ones", axes=(None,))


def _dense_ffn_specs(cfg, kind: str) -> dict:
    # the reference gives `dense_d_ff` to the MLA models' dense layers
    # only: every other kind takes d_ff
    d_ff = cfg.dense_d_ff if kind == "mla_dense" and cfg.dense_d_ff \
        else cfg.d_ff
    return mlp_specs(cfg.d_model, d_ff, cfg.act,
                     init_scale_out(cfg.total_layers))


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "mamba":
        return {"ln1": _norm(cfg), "ssm": ssm_specs(cfg)}
    if kind in _HYBRID:
        return {
            "ln1": _norm(cfg),
            "attn": attn.gqa_specs(cfg),
            "ssm": ssm_specs(cfg),
            "po_norm_a": _norm(cfg), "po_norm_s": _norm(cfg),
            "ln2": _norm(cfg), "mlp": _dense_ffn_specs(cfg, kind),
        }
    if kind not in ("dense", "moe") + _MLA:
        raise _not_ported(kind)
    out = {"ln1": _norm(cfg),
           "attn": attn.mla_specs(cfg) if kind in _MLA else
           attn.gqa_specs(cfg),
           "ln2": _norm(cfg)}
    if kind.endswith("moe"):
        out["moe"] = moe_specs(cfg)
    else:
        out["mlp"] = _dense_ffn_specs(cfg, kind)
    return out


def _stack(specs, n: int):
    if isinstance(specs, dict):
        return {k: _stack(v, n) for k, v in specs.items()}
    return ParamSpec((n, *specs.shape), specs.dtype, specs.init,
                     specs.scale, (None, *specs.axes))


def build_specs(cfg: ModelConfig) -> dict:
    V, d = cfg.vocab_padded, cfg.d_model
    out = {
        "embed": ParamSpec((V, d), scale=1.0 / math.sqrt(d),
                           axes=(None, "tp")),
        "final_norm": _norm(cfg),
        "unembed": ParamSpec((d, V), axes=("fsdp", "tp")),
        "groups": {g.name: _stack(block_specs(cfg, g.kind), g.n)
                   for g in plan(cfg)},
    }
    return out


def _layer(tree, i: int):
    """Layer ``i`` of a group's stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #
def _mix_and_mlp(p: dict, x, a_out, s_out, cfg):
    """Hymba's head mix ``0.5 * (norm(attn) + norm(ssm))``, the residual,
    then the MLP sub-block."""
    mixed = 0.5 * (rmsnorm(a_out, p["po_norm_a"], cfg.norm_eps)
                   + rmsnorm(s_out, p["po_norm_s"], cfg.norm_eps))
    x = x + mixed
    return _ffn("dense", p, x, cfg)


def _ffn(kind: str, p: dict, x, cfg):
    """The feed-forward sub-block and its residual: the routed experts
    of a ``moe`` or ``mla_moe`` block, else the MLP."""
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind.endswith("moe"):
        return x + moe_apply(p["moe"], h2, cfg)
    return x + mlp_apply(p["mlp"], h2, cfg.act)


def block_apply(kind: str, p: dict, x, cfg, positions):
    """Full-sequence (prefill) block.  Returns (x, cache entry)."""
    if kind == "mamba":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (conv_s, ssm_s) = ssm_prefill(p["ssm"], h, cfg)
        return x + y, {"conv": conv_s, "ssm": ssm_s}
    if kind in ("dense", "moe"):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.gqa_qkv(p["attn"], h, cfg, positions)
        o = flash_attention_op(q, k, v, cfg.sliding_window)
        x = _ffn(kind, p, x + attn.gqa_out(p["attn"], o), cfg)
        return x, {"k": k, "v": v}
    if kind in _MLA:
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v, c_kv, k_rope = attn.mla_qkv(p["attn"], h, cfg, positions)
        o = flash_attention_op(q, k, v)
        x = _ffn(kind, p, x + attn.mla_out(p["attn"], o), cfg)
        return x, {"ckv": c_kv, "kr": k_rope}
    if kind not in _HYBRID:
        raise _not_ported(kind)
    window = None if kind == "hybrid_full" else cfg.sliding_window
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.gqa_qkv(p["attn"], h, cfg, positions)
    o = flash_attention_op(q, k, v, window)
    a_out = attn.gqa_out(p["attn"], o)
    s_out, (conv_s, ssm_s) = ssm_prefill(p["ssm"], h, cfg)
    x = _mix_and_mlp(p, x, a_out, s_out, cfg)
    # the cache keeps the last `window` keys, or every prompt key
    W = window or k.shape[1]
    cache = {"k": k[:, -W:], "v": v[:, -W:], "conv": conv_s, "ssm": ssm_s}
    return x, cache


def _write_kv(cache_k, cache_v, k, v, pos: int, window: bool) -> None:
    """Write the new key and value at ``pos`` in place.  A ring (window)
    writes at ``pos % len``.  Without a window the index is clamped to the
    cache, as the reference's ``dynamic_update_slice`` clamps it: a cache
    built by prefill holds exactly the prompt, so every decode step
    overwrites its last slot."""
    W = cache_k.shape[1]
    wpos = pos % W if window else min(pos, W - 1)
    cache_k[:, wpos] = k[:, 0]
    cache_v[:, wpos] = v[:, 0]


def block_decode(kind: str, p: dict, x, cfg, cache: dict, pos: int):
    """x: [B,1,d]; updates the layer's ``cache`` in place, returns x."""
    if kind == "mamba":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (conv_s, ssm_s) = ssm_decode(p["ssm"], h, cfg, cache["conv"],
                                        cache["ssm"])
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        return x + y
    if kind not in _KINDS:
        raise _not_ported(kind)
    if kind in _MLA:
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        a_out = attn.mla_decode(p["attn"], h, cfg, cache["ckv"], cache["kr"],
                                pos)
        return _ffn(kind, p, x + a_out, cfg)
    window = None if kind == "hybrid_full" else cfg.sliding_window
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.gqa_qkv(p["attn"], h, cfg, positions)
    _write_kv(cache["k"], cache["v"], k, v, pos, window is not None)
    o = attn.decode_attention(q, cache["k"], cache["v"], pos, window=window)
    a_out = attn.gqa_out(p["attn"], o)
    if kind in ("dense", "moe"):
        return _ffn(kind, p, x + a_out, cfg)
    s_out, (conv_s, ssm_s) = ssm_decode(p["ssm"], h, cfg, cache["conv"],
                                        cache["ssm"])
    cache["conv"].copy_(conv_s)
    cache["ssm"].copy_(ssm_s)
    return _mix_and_mlp(p, x, a_out, s_out, cfg)


# ---------------------------------------------------------------------- #
# model-level passes
# ---------------------------------------------------------------------- #
def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def logits_from(params: dict, x, cfg) -> torch.Tensor:
    """bf16 logits over the padded vocabulary."""
    return proj("bsd,dv->bsv", rmsnorm(x, params["final_norm"], cfg.norm_eps),
                params["unembed"])


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """Prompt pass: tokens [B,S] -> (last-token logits [B,1,V], cache).

    The cache is ``{group: {"k", "v", "conv", "ssm"}}`` (a ``dense`` or
    ``moe`` group's ``{"k", "v"}``, every prompt key: ``[L, B, S, Hkv,
    D]``; an MLA group's ``{"ckv", "kr"}``, the latent and the rotated
    key of every prompt token: ``[L, B, S, kv_lora]`` and ``[L, B, S,
    rope_dim]``; a ``mamba`` group's ``{"conv", "ssm"}``: ``[L, B, di,
    K-1]`` and float32 ``[L, B, di, N]``) with each entry stacked over
    the group's layers, as the reference's."""
    B, S = tokens.shape
    x = embed(params, tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    caches = {}
    for g in plan(cfg):
        gp = params["groups"][g.name]
        entries = []
        for i in range(g.n):
            x, c = block_apply(g.kind, _layer(gp, i), x, cfg, positions)
            entries.append(c)
        caches[g.name] = {k: torch.stack([c[k] for c in entries])
                          for k in entries[0]}
    return logits_from(params, x[:, -1:], cfg), caches


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """tokens: [B,1]; pos: the tokens' position.  Returns (logits, cache),
    the cache updated in place."""
    x = embed(params, tokens)
    for g in plan(cfg):
        gp, gc = params["groups"][g.name], cache[g.name]
        for i in range(g.n):
            x = block_decode(g.kind, _layer(gp, i), x, cfg, _layer(gc, i),
                             pos)
    return logits_from(params, x, cfg), cache
