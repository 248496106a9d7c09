"""Model assembly: configuration, block program, prefill and decode.

The port of the reference's ``models/model.py`` for the kinds it runs.
A model is a block program: an ordered list of homogeneous groups, each
with its parameters stacked over its layers (``params["groups"][name]``
holds ``[n, ...]`` tensors), so parameter trees and caches have the
reference's layout leaf for leaf.  The port walks each group's layers in
a Python loop where the reference scans.

Three entry points: :func:`forward_train` gives the logits of every
position for training (:func:`loss_fn` their masked cross-entropy), each
block under the config's ``remat`` mode (:func:`maybe_remat`, torch's
activation checkpointing); :func:`prefill` builds the decode cache from
a prompt (and, for a model with context tokens, a context: vision
tokens, audio frames) and :func:`decode_step` runs one token against it,
updating the cache in place (the reference returns a new cache).  The
kinds, every one of the reference's: ``dense`` (GQA attention and an
MLP: Qwen3, Nemotron, StarCoder2, Command R+), ``moe`` (GQA attention and the routed
experts of ``models.moe``: the Qwen3 MoE), ``mla_dense`` and ``mla_moe``
(MLA attention and an MLP or the routed experts: DeepSeek-V3),
``hybrid`` and ``hybrid_full`` (Hymba), the attention-free ``mamba``
(falcon-mamba), ``vision_super`` (``cross_every - 1`` self-attention
layers and one gated cross-attention layer over the vision tokens:
Llama-3.2-Vision) and ``enc`` / ``dec`` (an encoder over the audio
frames, not causal, and a decoder whose layers cross-attend its output:
SeamlessM4T).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.flash_attention import flash_attention_op
from ..parallel.sharding import as_dtensor, is_dtensor, reduce_partial
from . import attention as attn
from .common import (ParamSpec, count_params, device_of, init_scale_out,
                     mlp_apply, mlp_specs, pad_vocab, proj, rmsnorm)
from .moe import MoECfg, moe_apply, moe_specs
from .ssm import ssm_decode, ssm_prefill, ssm_specs

__all__ = ["MLACfg", "ModelConfig", "Group", "plan", "block_specs",
           "build_specs", "embed", "logits_from", "block_apply",
           "block_decode", "prefill", "decode_step", "maybe_remat",
           "DOT_OPS", "forward_train", "loss_fn"]

_HYBRID = ("hybrid", "hybrid_full")
_MLA = ("mla_dense", "mla_moe")


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
    # cross-attention context (vision tokens / audio frames)
    cross_every: int = 0            # vlm: 1 cross layer per `cross_every`
    n_ctx_tokens: int = 0
    # encoder-decoder
    enc_dec: bool = False
    enc_layers: int = 0
    # training: activation checkpointing of each block (full | dots | none)
    remat: str = "full"

    @property
    def total_layers(self) -> int:
        """Layers of the whole model, an encoder's included: they set
        every output projection's init scale."""
        return self.n_layers + self.enc_layers

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
    """The groups of layers, in order (the reference's ``plan``): an
    encoder-decoder is its ``enc`` layers then its ``dec`` layers; a
    vision model one group of ``vision_super`` blocks, ``cross_every``
    layers each; an SSM model one group of ``mamba`` layers; a hybrid has
    runs of sliding-window layers between the full-attention layers, each
    full-attention layer a group of its own; an MoE model its leading
    ``dense`` layers, then its ``moe`` layers (``mla_dense`` and
    ``mla_moe`` where it has MLA); any other, one group of ``dense``
    layers."""
    if cfg.enc_dec:
        return [Group("enc", cfg.enc_layers, "enc"),
                Group("dec", cfg.n_layers, "dec")]
    if cfg.family == "vlm":
        if not cfg.cross_every or cfg.n_layers % cfg.cross_every:
            raise ValueError(f"a vision model's {cfg.n_layers} layers are "
                             f"not whole super-blocks of {cfg.cross_every}")
        return [Group("vision_super", cfg.n_layers // cfg.cross_every, "vs")]
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


def _gqa_block_specs(cfg, kind: str) -> dict:
    return {"ln1": _norm(cfg), "attn": attn.gqa_specs(cfg),
            "ln2": _norm(cfg), "mlp": _dense_ffn_specs(cfg, kind)}


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "mamba":
        return {"ln1": _norm(cfg), "ssm": ssm_specs(cfg)}
    if kind == "vision_super":
        # the self layers stacked once more, [cross_every - 1, ...]; the
        # gates are float32 scalars drawn as zeros
        gate = ParamSpec((), "float32", "zeros", axes=())
        return {"self": _stack(_gqa_block_specs(cfg, kind),
                               cfg.cross_every - 1),
                "cross": {**_gqa_block_specs(cfg, kind),
                          "gate_attn": gate, "gate_mlp": gate}}
    if kind == "dec":
        return {**_gqa_block_specs(cfg, kind), "lnx": _norm(cfg),
                "xattn": attn.gqa_specs(cfg)}
    if kind == "enc":
        return _gqa_block_specs(cfg, kind)
    if kind in _HYBRID:
        return {
            "ln1": _norm(cfg),
            "attn": attn.gqa_specs(cfg),
            "ssm": ssm_specs(cfg),
            "po_norm_a": _norm(cfg), "po_norm_s": _norm(cfg),
            "ln2": _norm(cfg), "mlp": _dense_ffn_specs(cfg, kind),
        }
    if kind not in ("dense", "moe") + _MLA:
        raise ValueError(f"unknown block kind {kind!r}")
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
    if cfg.enc_dec:
        out["enc_final_norm"] = _norm(cfg)
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


def _ffn(kind: str, p: dict, x, cfg, sh=None):
    """The feed-forward sub-block and its residual: the routed experts
    of a ``moe`` or ``mla_moe`` block (split over the sharder's mesh
    where there is one), else the MLP."""
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind.endswith("moe"):
        return x + moe_apply(p["moe"], h2, cfg, sh)
    return x + mlp_apply(p["mlp"], h2, cfg.act)


def _self_attn(p: dict, x, cfg, positions, causal: bool = True,
               window: Optional[int] = None):
    """The self-attention sub-block and its residual, through the
    flash-attention op; returns (x, k, v)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.gqa_qkv(p["attn"], h, cfg, positions)
    o = flash_attention_op(q, k, v, window, causal)
    return x + attn.gqa_out(p["attn"], o), k, v


def _cross_kv(p_attn: dict, ctx, cfg):
    """A cross-attention's keys and values from the context (vision
    tokens, the encoder's output): projected, no RoPE."""
    k = proj("bsd,dhk->bshk", ctx, p_attn["wk"])
    v = proj("bsd,dhk->bshk", ctx, p_attn["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p_attn["k_norm"], cfg.norm_eps)
    return k.contiguous(), v.contiguous()


def _cross_q(p_attn: dict, h, cfg):
    """A cross-attention's queries: projected, no RoPE."""
    q = proj("bsd,dhk->bshk", h, p_attn["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p_attn["q_norm"], cfg.norm_eps)
    return q.contiguous()


def _gate(g, x):
    """A cross layer's gate: ``tanh`` of the float32 scalar, cast to the
    residual's dtype (the product with the branch is taken in it)."""
    return torch.tanh(g).to(x.dtype)


def _gated_cross(pc: dict, x, attend, cfg):
    """The vision super-block's gated cross layer: ``x + tanh(gate_attn)
    * attention`` then ``x + tanh(gate_mlp) * MLP``; ``attend(q)``
    attends the context (prefill's or decode's)."""
    h = rmsnorm(x, pc["ln1"], cfg.norm_eps)
    o = attend(_cross_q(pc["attn"], h, cfg))
    x = x + _gate(pc["gate_attn"], x) * attn.gqa_out(pc["attn"], o)
    h2 = rmsnorm(x, pc["ln2"], cfg.norm_eps)
    return x + _gate(pc["gate_mlp"], x) * mlp_apply(pc["mlp"], h2, cfg.act)


def block_apply(kind: str, p: dict, x, cfg, positions, ctx=None, sh=None):
    """Full-sequence (prefill) block; ``ctx`` [B, Sc, d] is the context a
    ``vision_super`` or ``dec`` block cross-attends (vision tokens, the
    encoder's output); ``sh`` the sharder of a model laid out over ranks
    (its MoE splits the experts).  Returns (x, cache entry)."""
    if kind == "mamba":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (conv_s, ssm_s) = ssm_prefill(p["ssm"], h, cfg)
        return x + y, {"conv": conv_s, "ssm": ssm_s}
    if kind in ("dense", "moe", "enc"):
        # the encoder's attention is not causal and its layers keep no cache
        x, k, v = _self_attn(p, x, cfg, positions, kind != "enc",
                             cfg.sliding_window)
        x = _ffn(kind, p, x, cfg, sh)
        return x, ({} if kind == "enc" else {"k": k, "v": v})
    if kind == "dec":
        x, k, v = _self_attn(p, x, cfg, positions)
        ck, cv = _cross_kv(p["xattn"], ctx, cfg)
        hx = rmsnorm(x, p["lnx"], cfg.norm_eps)
        ox = flash_attention_op(_cross_q(p["xattn"], hx, cfg), ck, cv,
                                causal=False)
        x = _ffn(kind, p, x + attn.gqa_out(p["xattn"], ox), cfg)
        return x, {"k": k, "v": v, "ck": ck, "cv": cv}
    if kind == "vision_super":
        ks, vs = [], []
        for i in range(cfg.cross_every - 1):
            pi = _layer(p["self"], i)
            x, k, v = _self_attn(pi, x, cfg, positions)
            x = _ffn(kind, pi, x, cfg)
            ks.append(k)
            vs.append(v)
        ck, cv = _cross_kv(p["cross"]["attn"], ctx, cfg)
        x = _gated_cross(p["cross"], x, lambda q: flash_attention_op(
            q, ck, cv, causal=False), cfg)
        return x, {"k": torch.stack(ks), "v": torch.stack(vs), "ck": ck,
                   "cv": cv}
    if kind in _MLA:
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v, c_kv, k_rope = attn.mla_qkv(p["attn"], h, cfg, positions)
        o = flash_attention_op(q, k, v)
        x = _ffn(kind, p, x + attn.mla_out(p["attn"], o), cfg, sh)
        return x, {"ckv": c_kv, "kr": k_rope}
    if kind not in _HYBRID:
        raise ValueError(f"unknown block kind {kind!r}")
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
    attn.write_at(cache_k, k, wpos)
    attn.write_at(cache_v, v, wpos)


def _attn_decode(p: dict, h, cfg, k_cache, v_cache, pos: int,
                 window: Optional[int] = None):
    """One token's self-attention output (before the residual) against
    its layer's cache, the token's key and value written in place."""
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=device_of(h))
    q, k, v = attn.gqa_qkv(p["attn"], h, cfg, positions)
    _write_kv(k_cache, v_cache, k, v, pos, window is not None)
    o = attn.decode_attention(q, k_cache, v_cache, pos, window=window)
    return attn.gqa_out(p["attn"], o)


def _context_attention(q, ck, cv):
    """One token's cross-attention over the whole context cache (the
    reference's ``pos = Sc - 1``: every slot valid)."""
    return attn.decode_attention(q, ck, cv, ck.shape[1] - 1)


def block_decode(kind: str, p: dict, x, cfg, cache: dict, pos: int,
                 sh=None):
    """x: [B,1,d]; updates the layer's ``cache`` in place, returns x."""
    if kind == "mamba":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (conv_s, ssm_s) = ssm_decode(p["ssm"], h, cfg, cache["conv"],
                                        cache["ssm"])
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
        return x + y
    if kind in _MLA:
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        a_out = attn.mla_decode(p["attn"], h, cfg, cache["ckv"], cache["kr"],
                                pos)
        return _ffn(kind, p, x + a_out, cfg, sh)
    if kind == "vision_super":
        for i in range(cfg.cross_every - 1):
            pi = _layer(p["self"], i)
            h = rmsnorm(x, pi["ln1"], cfg.norm_eps)
            x = x + _attn_decode(pi, h, cfg, cache["k"][i], cache["v"][i],
                                 pos)
            x = _ffn(kind, pi, x, cfg)
        return _gated_cross(p["cross"], x, lambda q: _context_attention(
            q, cache["ck"], cache["cv"]), cfg)
    if kind == "dec":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = x + _attn_decode(p, h, cfg, cache["k"], cache["v"], pos)
        hx = rmsnorm(x, p["lnx"], cfg.norm_eps)
        ox = _context_attention(_cross_q(p["xattn"], hx, cfg), cache["ck"],
                                cache["cv"])
        return _ffn(kind, p, x + attn.gqa_out(p["xattn"], ox), cfg)
    if kind not in ("dense", "moe") + _HYBRID:
        raise ValueError(f"unknown block kind {kind!r}")
    window = None if kind == "hybrid_full" else cfg.sliding_window
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a_out = _attn_decode(p, h, cfg, cache["k"], cache["v"], pos, window)
    if kind in ("dense", "moe"):
        return _ffn(kind, p, x + a_out, cfg, sh)
    s_out, (conv_s, ssm_s) = ssm_decode(p["ssm"], h, cfg, cache["conv"],
                                        cache["ssm"])
    cache["conv"].copy_(conv_s)
    cache["ssm"].copy_(ssm_s)
    return _mix_and_mlp(p, x, a_out, s_out, cfg)


# ---------------------------------------------------------------------- #
# model-level passes
# ---------------------------------------------------------------------- #
def embed(params: dict, tokens: torch.Tensor, sh=None) -> torch.Tensor:
    """The tokens' rows of the embedding, constrained to the batch (and
    sequence) split where the model is laid out over ranks."""
    x = params["embed"][tokens.long()]
    return x if sh is None else sh.constrain_safe(x, "dp", "sp", None)


def logits_from(params: dict, x, cfg) -> torch.Tensor:
    """bf16 logits over the padded vocabulary."""
    return proj("bsd,dv->bsv", rmsnorm(x, params["final_norm"], cfg.norm_eps),
                params["unembed"])


def _encode(params: dict, ctx, cfg, remat: bool = False, sh=None):
    """An encoder-decoder's encoder over the context (audio frames) [B,
    Sc, d]: its ``enc`` layers, not causal, RoPE over the frames'
    positions (each under the config's ``remat`` when ``remat``), then
    ``enc_final_norm``: the memory the decoder's cross layers attend."""
    B, S = ctx.shape[:2]
    positions = _positions(B, S, ctx)
    g = plan(cfg)[0]
    x = _run_group(g, params["groups"][g.name], ctx, cfg, positions, None,
                   remat, sh)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


# the matrix products whose outputs ``remat="dots"`` keeps (the
# reference's ``checkpoint_dots``): einsum and matmul reach these
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn, cfg):
    """``fn`` under the config's activation checkpointing, the
    reference's ``_maybe_remat``: ``full`` keeps only the inputs and
    recomputes the whole block in the backward, ``dots`` keeps the
    outputs of the matrix products (``DOT_OPS``) and recomputes the rest,
    ``none`` keeps what autograd keeps."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    if cfg.remat == "none":
        return fn
    raise ValueError(f"unknown remat mode {cfg.remat!r}")


def _positions(B: int, S: int, x) -> torch.Tensor:
    """int32 positions 0 .. S-1 of each of B rows, on ``x``'s data's
    device."""
    return torch.arange(S, dtype=torch.int32,
                        device=device_of(x)).expand(B, S)


def _constrained(x, sh):
    """A block's output constrained to the batch (and sequence) split,
    the reference's ``constrain_safe(y, "dp", "sp", None)``."""
    return x if sh is None else sh.constrain_safe(x, "dp", "sp", None)


def _run_group(g, gp, x, cfg, positions, ctx, remat: bool, sh=None):
    """One group's layers in turn, each block under the config's
    ``remat`` when ``remat``; the blocks' caches are dropped."""
    def body(y, p):
        return _constrained(
            block_apply(g.kind, p, y, cfg, positions, ctx, sh)[0], sh)
    if remat:
        body = maybe_remat(body, cfg)
    for i in range(g.n):
        x = body(x, _layer(gp, i))
    return x


def forward_train(params: dict, batch: dict, cfg: ModelConfig, sh=None):
    """batch: ``{"tokens": [B,S] int}`` (and ``"ctx"`` [B,Sc,d] bf16 for
    a model with context tokens; ``"labels"`` is not read).  Returns the
    bf16 logits of every position, [B,S,V] over the padded vocabulary.
    An encoder-decoder runs its encoder on ``ctx`` first, then its
    decoder groups.  ``sh``: the sharder of a model laid out over ranks
    (DTensor parameters and batch); each block's output is constrained
    to the batch split, as the reference's."""
    tokens = batch["tokens"]
    ctx = batch.get("ctx")
    _check_ctx(ctx, tokens, cfg)
    B, S = tokens.shape
    x = embed(params, tokens, sh)
    positions = _positions(B, S, x)
    if cfg.enc_dec:
        ctx = _encode(params, ctx, cfg, remat=True, sh=sh)
    for g in _decoder_groups(cfg):
        x = _run_group(g, params["groups"][g.name], x, cfg, positions, ctx,
                       remat=True, sh=sh)
    return logits_from(params, x, cfg)


def _vocab_split(lf):
    """(mesh, vocab split of each mesh dim, the rows' placements, lf's
    placements) of DTensor logits lf [..., V]: a mesh dim splits the
    vocabulary, or the rows (kept), or nothing."""
    from torch.distributed.tensor import Replicate, Shard
    last = lf.dim() - 1
    split = [isinstance(p, Shard) and p.dim == last for p in lf.placements]
    rows = [Shard(p.dim) if isinstance(p, Shard) and not s else Replicate()
            for p, s in zip(lf.placements, split)]
    lf_p = [Shard(last) if s else r for s, r in zip(split, rows)]
    return lf.device_mesh, split, rows, lf_p


def _logsumexp(lf):
    """``logsumexp`` over the last dim.  On a DTensor whose vocabulary is
    split, each rank sums ``exp(lf - m)`` over its part (``m`` the row
    max, reduced across the split) and the sums are reduced: rows move,
    never the logits."""
    if not is_dtensor(lf):
        return torch.logsumexp(lf, dim=-1)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    dm, split, rows, lf_p = _vocab_split(lf)
    m = reduce_partial(lf.detach().amax(-1, keepdim=True))
    total = local_map(
        lambda x, mm: torch.exp(x - mm).sum(-1, keepdim=True),
        out_placements=[Partial() if s else r for s, r in zip(split, rows)],
        in_placements=(lf_p, rows), in_grad_placements=(lf_p, rows),
        device_mesh=dm, redistribute_inputs=True)(lf, m)
    return (m + torch.log(reduce_partial(total)))[..., 0]


def _gold_logit(lf, labels):
    """``lf[..., labels]``: each position's logit of its label.  On a
    DTensor whose vocabulary is split, each rank takes the labels that
    fall in its part of it (zero elsewhere) and the sum over the split
    is left to DTensor (a ``Partial``), GSPMD's gather on a split dim."""
    if not is_dtensor(lf):
        return lf.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    dm, split, rows, lf_p = _vocab_split(lf)

    def local(lfl, lab):
        v = lfl.shape[-1]
        v0 = 0
        for i, s in enumerate(split):
            if s:
                v0 = v0 * dm.size(i) + dm.get_local_rank(i)
        idx = lab.long() - v0 * v
        inside = (idx >= 0) & (idx < v)
        g = lfl.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))
    return local_map(local, out_placements=[
        Partial() if s else r for s, r in zip(split, rows)],
        in_placements=(lf_p, rows), device_mesh=dm,
        redistribute_inputs=True)(lf, as_dtensor(labels, dm))


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions whose label is
    ``>= 0``: float32 ``logsumexp`` of the logits less the gold logit,
    summed and divided by ``max(count, 1)``."""
    logits = forward_train(params, batch, cfg, sh)
    labels = batch["labels"].long()
    lf = logits.float()
    lse = _logsumexp(lf)
    gold = _gold_logit(lf, labels.clamp_min(0))
    mask = labels >= 0
    nll = torch.where(mask, lse - gold, torch.zeros_like(lse))
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _decoder_groups(cfg) -> list:
    """The groups a prefill and a decode step run: an encoder-decoder's
    ``enc`` group runs once, on the context, in the prefill."""
    return plan(cfg)[1:] if cfg.enc_dec else plan(cfg)


def _check_ctx(ctx, tokens, cfg) -> None:
    """A model with context tokens needs its context, and one without
    takes none: ``ctx`` [B, Sc, d] bf16, the tokens' batch."""
    if not cfg.n_ctx_tokens:
        if ctx is not None:
            raise ValueError(f"{cfg.name} takes no context (ctx)")
        return
    if ctx is None:
        raise ValueError(f"{cfg.name} attends {cfg.n_ctx_tokens} context "
                         "tokens a request: pass ctx [B, Sc, d]")
    if ctx.dim() != 3 or ctx.shape[0] != tokens.shape[0] or \
            ctx.shape[2] != cfg.d_model or ctx.shape[1] < 1:
        raise ValueError(f"ctx must be [B={tokens.shape[0]}, Sc >= 1, "
                         f"d={cfg.d_model}], got {tuple(ctx.shape)}")
    if ctx.dtype != torch.bfloat16:
        raise TypeError(f"ctx has dtype {ctx.dtype}, expected torch.bfloat16")


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Optional[torch.Tensor] = None, sh=None):
    """Prompt pass: tokens [B,S] (and, for a model with context tokens,
    the bf16 context ``ctx`` [B,Sc,d]: vision tokens, or the audio frames
    the encoder reads) -> (last-token logits [B,1,V], cache).

    The cache is ``{group: {...}}`` with each entry stacked over the
    group's layers, as the reference's: a ``dense`` or ``moe`` group's
    ``{"k", "v"}``, every prompt key: ``[L, B, S, Hkv, D]``; an MLA
    group's ``{"ckv", "kr"}``, the latent and the rotated key of every
    prompt token: ``[L, B, S, kv_lora]`` and ``[L, B, S, rope_dim]``; a
    ``mamba`` group's ``{"conv", "ssm"}``: ``[L, B, di, K-1]`` and
    float32 ``[L, B, di, N]``; a ``vision_super`` group's self layers'
    ``{"k", "v"}``: ``[L, cross_every - 1, B, S, Hkv, D]`` and its cross
    layer's context keys and values ``{"ck", "cv"}``: ``[L, B, Sc, Hkv,
    D]``; a ``dec`` group's ``{"k", "v", "ck", "cv"}`` (an encoder keeps
    none).  ``sh``: as :func:`forward_train`'s."""
    _check_ctx(ctx, tokens, cfg)
    B, S = tokens.shape
    x = embed(params, tokens, sh)
    positions = _positions(B, S, x)
    if cfg.enc_dec:
        ctx = _encode(params, ctx, cfg, sh=sh)
    caches = {}
    for g in _decoder_groups(cfg):
        gp = params["groups"][g.name]
        entries = []
        for i in range(g.n):
            x, c = block_apply(g.kind, _layer(gp, i), x, cfg, positions, ctx,
                               sh)
            x = _constrained(x, sh)
            entries.append(c)
        caches[g.name] = {k: torch.stack([c[k] for c in entries])
                          for k in entries[0]}
    return logits_from(params, x[:, -1:], cfg), caches


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, sh=None):
    """tokens: [B,1]; pos: the tokens' position.  Returns (logits, cache),
    the cache updated in place (a cross layer reads its context keys and
    values from it).  ``sh``: as :func:`forward_train`'s."""
    x = embed(params, tokens, sh)
    for g in _decoder_groups(cfg):
        gp, gc = params["groups"][g.name], cache[g.name]
        for i in range(g.n):
            x = block_decode(g.kind, _layer(gp, i), x, cfg, _layer(gc, i),
                             pos, sh)
    return logits_from(params, x, cfg), cache
