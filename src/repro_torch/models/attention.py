"""Attention: GQA with RoPE, and MLA (DeepSeek-V3), for prefill and for
one-token decode.

Prefill runs causal attention, full or over a sliding window, and the
non-causal attention of an encoder and of a cross layer over a context,
through ``kernels.flash_attention.flash_attention_op`` (called by the
model): the hand-written CUDA kernel on the card, its plain PyTorch
version on the CPU.  MLA's prefill is the reference's expanded form:
per-head keys and values from the latent, queries and keys ``nope_dim +
rope_dim`` wide and values ``v_dim`` wide, through the same op.  Decode
(one new token against the cache) is one fused pass in plain PyTorch, as
in the reference; MLA's is the absorbed form, which attends the latent
cache directly.  Layouts are the reference's: ``[B, S, H, D]`` for queries,
keys and values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import NEG
from ..parallel.sharding import as_dtensor, is_dtensor
from .common import (ParamSpec, apply_rope, device_of, fdot,
                     init_scale_out, proj, rmsnorm, rope_freqs)

__all__ = ["gqa_specs", "gqa_qkv", "gqa_out", "write_at", "decode_attention",
           "mla_specs", "mla_latent", "mla_queries", "mla_qkv", "mla_out",
           "mla_decode"]


def gqa_specs(cfg) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the reference's tensor-parallel axis: over the heads, or over the head
    # dim where the heads do not divide (tp_heads=False, Hymba)
    h_ax, d_ax = ("tp", None) if cfg.tp_heads else (None, "tp")
    out = {
        "wq": ParamSpec((d, H, hd), axes=("fsdp", h_ax, d_ax)),
        "wk": ParamSpec((d, Hkv, hd), axes=("fsdp", h_ax, d_ax)),
        "wv": ParamSpec((d, Hkv, hd), axes=("fsdp", h_ax, d_ax)),
        "wo": ParamSpec((H, hd, d), scale=init_scale_out(cfg.total_layers),
                        axes=(h_ax, d_ax, "fsdp")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((hd,), "float32", "ones", axes=(None,))
        out["k_norm"] = ParamSpec((hd,), "float32", "ones", axes=(None,))
    return out


def gqa_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Project and rotate; returns contiguous bf16 q [B,S,H,D] and k, v
    [B,S,Hkv,D]."""
    q = proj("bsd,dhk->bshk", x, p["wq"])
    k = proj("bsd,dhk->bshk", x, p["wk"])
    v = proj("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
        cos, sin = cos[:, :, None], sin[:, :, None]    # [B,S,1,hd/2]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    return proj("bshk,hkd->bsd", o, p["wo"])


def write_at(cache: torch.Tensor, new: torch.Tensor, wpos: int) -> None:
    """``cache[:, wpos] = new[:, 0]`` in place.  On a DTensor cache split
    along its positions, only the rank whose part holds ``wpos`` writes,
    into its own shard (the other dims of ``new`` split as the cache's)."""
    if not is_dtensor(cache):
        cache[:, wpos] = new[:, 0]
        return
    from torch.distributed.tensor import Replicate, Shard
    dm = cache.device_mesh
    local = cache._local_tensor
    start = 0
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            start = start * dm.size(i) + dm.get_local_rank(i)
    start *= local.shape[1]
    # every rank takes part in the redistribution, a collective
    new = as_dtensor(new, dm).redistribute(dm, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in cache.placements])
    if start <= wpos < start + local.shape[1]:
        local[:, wpos - start] = new._local_tensor[:, 0]


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     window: Optional[int] = None):
    """q: [B,1,H,D]; caches: [B,S,Hkv,D] (a ring when ``window`` is set).

    The reference's validity rule: slots past ``pos`` are masked, and with
    a window the whole ring counts as valid once ``pos >= S``.  Softmax
    in float32, ``p`` rounded to the values' dtype before ``p·v``.
    """
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    kr = k_cache.repeat_interleave(g, dim=2)
    vr = v_cache.repeat_interleave(g, dim=2)
    s = fdot("bqhd,bkhd->bhk", q, kr) * (1.0 / math.sqrt(D))
    idx = torch.arange(S, device=device_of(q))
    valid = idx <= pos
    if window is not None and pos >= S:
        valid = torch.ones_like(valid)
    s = torch.where(valid[None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = fdot("bhk,bkhd->bhd", p.to(vr.dtype), vr)
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------- #
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------- #
def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wq_a": ParamSpec((d, m.q_lora), axes=("fsdp", None)),
        "q_norm": ParamSpec((m.q_lora,), "float32", "ones", axes=(None,)),
        "wq_b": ParamSpec((m.q_lora, H, m.nope_dim + m.rope_dim),
                          axes=(None, "tp", None)),
        "wkv_a": ParamSpec((d, m.kv_lora + m.rope_dim), axes=("fsdp", None)),
        "kv_norm": ParamSpec((m.kv_lora,), "float32", "ones", axes=(None,)),
        "wk_b": ParamSpec((m.kv_lora, H, m.nope_dim), axes=(None, "tp", None)),
        "wv_b": ParamSpec((m.kv_lora, H, m.v_dim), axes=(None, "tp", None)),
        "wo": ParamSpec((H, m.v_dim, d),
                        scale=init_scale_out(cfg.total_layers),
                        axes=("tp", None, "fsdp")),
    }


def mla_latent(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """The compressed key-value latent ``c_kv`` [B,S,kv_lora] (normed)
    and the rotated key ``k_rope`` [B,S,rope_dim], one head shared by
    every query head."""
    m = cfg.mla
    ckv = proj("bsd,dc->bsc", x, p["wkv_a"])
    c_kv, k_rope = ckv[..., :m.kv_lora], ckv[..., m.kv_lora:]
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(m.rope_dim, cfg.rope_theta, positions)
    return c_kv, apply_rope(k_rope, cos, sin)


def mla_queries(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """``q_nope`` [B,S,H,nope_dim] and the rotated ``q_rope``
    [B,S,H,rope_dim], through the low-rank ``wq_a`` and ``wq_b``."""
    m = cfg.mla
    cq = proj("bsd,dq->bsq", x, p["wq_a"])
    q = proj("bsq,qhk->bshk", rmsnorm(cq, p["q_norm"], cfg.norm_eps),
             p["wq_b"])
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    cos, sin = rope_freqs(m.rope_dim, cfg.rope_theta, positions)
    return q_nope, apply_rope(q_rope, cos[:, :, None], sin[:, :, None])


def mla_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """The expanded form for prefill: contiguous bf16 ``q = [q_nope,
    q_rope]`` and ``k = [k_nope, k_rope]`` [B,S,H,nope_dim + rope_dim]
    (``k_rope`` repeated over the heads), ``v`` [B,S,H,v_dim] from the
    latent, and the cache entries ``c_kv``, ``k_rope``."""
    m = cfg.mla
    c_kv, k_rope = mla_latent(p, x, cfg, positions)
    q_nope, q_rope = mla_queries(p, x, cfg, positions)
    k_nope = proj("bsc,chk->bshk", c_kv, p["wk_b"])
    v = proj("bsc,chk->bshk", c_kv, p["wv_b"])
    k_rope_b = k_rope[:, :, None].expand(*k_rope.shape[:2], cfg.n_heads,
                                         m.rope_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b.to(k_nope.dtype)], -1)
    return q, k, v.contiguous(), c_kv, k_rope


def mla_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    return proj("bshk,hkd->bsd", o, p["wo"])


def mla_decode(p: dict, x: torch.Tensor, cfg, c_kv_cache: torch.Tensor,
               k_rope_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """The absorbed form, x [B,1,d] -> [B,1,d]: writes the token's latent
    and rotated key at ``pos`` in place (clamped to the cache's last
    slot, as the reference's ``dynamic_update_slice`` clamps it), folds
    ``wk_b`` into the query and attends the latent cache directly.  The
    reference's order: ``q_c`` in float32 rounded to bf16, the scores in
    float32 masked past ``pos``, a float32 softmax rounded to bf16 before
    ``p·c_kv``, then ``wv_b`` and ``wo``."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=device_of(x))
    c_kv_new, k_rope_new = mla_latent(p, x, cfg, positions)
    S = c_kv_cache.shape[1]
    wpos = min(pos, S - 1)
    write_at(c_kv_cache, c_kv_new, wpos)
    write_at(k_rope_cache, k_rope_new, wpos)
    q_nope, q_rope = mla_queries(p, x, cfg, positions)
    q_c = fdot("bshk,chk->bshc", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)
    s = (fdot("bshc,btc->bhst", q_c.to(torch.bfloat16), c_kv_cache)
         + fdot("bshk,btk->bhst", q_rope, k_rope_cache)) * scale
    valid = torch.arange(S, device=device_of(x)) <= pos
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG))
    pattn = torch.softmax(s, dim=-1)
    ctx = fdot("bhst,btc->bshc", pattn.to(torch.bfloat16), c_kv_cache)
    o = proj("bshc,chk->bshk", ctx, p["wv_b"])
    return mla_out(p, o)
