"""Mixture-of-Experts FFN on one device: routing, capacity, experts, combine.

The port of the reference's ``models/moe.py`` for one device, where its
expert-parallel split has one rank (``n_tp = n_dp = 1``): every token is
routed among all ``E`` experts.  The port's models take no sharder, so an
expert split over devices is not ported (ROADMAP queue 1 item 16).

The steps, each a function of its own so that they can be timed apart:

1. :func:`router_logits` — the float32 router ``x @ router`` ``[T, E]``;
2. :func:`route` — the top-``k`` experts of each token (ties to the lower
   expert, as ``jax.lax.top_k``), the softmax of their logits (with
   ``router_scale_bias`` the choice is on ``sigmoid + bias``), and each
   expert's first ``cap`` assignments in token order, ``cap = max(4,
   int(T k capacity_factor / E))``: later ones are dropped;
3. :func:`gather` — each expert's ``[cap, d]`` tokens, and
   :func:`expert_ffn` — each expert's SwiGLU FFN on them as one batched
   product, scaled by the gates in bf16;
4. :func:`combine` — each token's rows added in bf16 in the order of
   its experts' indices, the reference's scatter-add order, rounding
   after every add as the reference's XLA does on a CPU.  The adds are
   ``top_k`` gathers and bf16 additions, with no atomics, so two runs
   give the same bits on the card.

Plus the shared experts where ``n_shared``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import ParamSpec, init_scale_out, proj

__all__ = ["MoECfg", "moe_specs", "capacity", "router_logits", "route",
           "gather", "expert_ffn", "combine", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_scale_bias: bool = False    # DeepSeek aux-loss-free bias


def moe_specs(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    scale_out = init_scale_out(cfg.total_layers)
    out = {
        "router": ParamSpec((d, m.n_experts), "float32", axes=(None, None)),
        "wi": ParamSpec((m.n_experts, d, 2, m.d_expert),
                        axes=("tp", "fsdp", None, None)),
        "wo": ParamSpec((m.n_experts, m.d_expert, d), scale=scale_out,
                        axes=("tp", None, "fsdp")),
    }
    if m.router_scale_bias:
        out["router_bias"] = ParamSpec((m.n_experts,), "float32", "zeros",
                                       axes=(None,))
    if m.n_shared:
        out["shared_wi"] = ParamSpec((d, 2, m.n_shared * m.d_expert),
                                     axes=("fsdp", None, "tp"))
        out["shared_wo"] = ParamSpec((m.n_shared * m.d_expert, d),
                                     scale=scale_out, axes=("tp", "fsdp"))
    return out


def capacity(m: MoECfg, n_tokens: int) -> int:
    """Assignments an expert takes from ``n_tokens`` tokens."""
    return max(4, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def router_logits(p: dict, xt: torch.Tensor) -> torch.Tensor:
    """xt: [T, d] -> float32 [T, E].  The product must be float32: a
    TF32 or reduced-precision float32 product would move the choice of
    experts, so the matmul settings are checked here."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the MoE router needs full float32 products: "
            "torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32} and the float32 "
            f"matmul precision {torch.get_float32_matmul_precision()!r}")
    return xt.float() @ p["router"].float()


def route(p: dict, logits: torch.Tensor, m: MoECfg) -> dict:
    """The routing of ``logits`` [T, E]: ``experts`` and ``gates`` [T, k]
    (the top-k in descending order of score, ties to the lower expert;
    float32 softmax of their logits), ``cap``, ``rank`` [T, k] (the
    assignment's place in its expert's token-ordered list), ``kept``
    [T, k] (``rank < cap``), and ``tok``, ``gate`` [E, cap]: each
    expert's slots (token 0 and gate 0 where a slot is empty)."""
    T, E = logits.shape
    k = m.top_k
    score = logits
    if "router_bias" in p:                 # aux-loss-free load balance
        score = torch.sigmoid(logits) + p["router_bias"].float()
    # a stable descending sort keeps tied scores in index order
    experts = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    gates = torch.softmax(logits.gather(1, experts), dim=-1)
    cap = capacity(m, T)
    # rank of each assignment among its expert's, in flat (token) order;
    # integer sums and sorts, no step that waits for the host
    dev = logits.device
    flat_e = experts.reshape(-1)
    flat = torch.arange(T * k, device=dev)
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = flat - starts[flat_e[order]]
    kept = rank < cap
    # a dropped assignment writes to a sink slot past the end
    slot = torch.where(kept, flat_e * cap + rank, E * cap)
    tok = torch.zeros(E * cap + 1, dtype=torch.long, device=dev)
    gate = torch.zeros(E * cap + 1, dtype=gates.dtype, device=dev)
    tok[slot] = torch.div(flat, k, rounding_mode="floor")
    gate[slot] = gates.reshape(-1)
    return {"experts": experts, "gates": gates, "cap": cap,
            "rank": rank.reshape(T, k), "kept": kept.reshape(T, k),
            "tok": tok[:-1].reshape(E, cap),
            "gate": gate[:-1].reshape(E, cap)}


def gather(xt: torch.Tensor, r: dict) -> torch.Tensor:
    """Each expert's ``cap`` tokens of xt [T, d]: [E, cap, d] (token 0 in
    an empty slot, whose gate is 0)."""
    E, cap = r["tok"].shape
    return xt[r["tok"].reshape(-1)].reshape(E, cap, -1)


def expert_ffn(p: dict, xs: torch.Tensor, r: dict) -> torch.Tensor:
    """Each expert's SwiGLU FFN on its gathered tokens xs [E, cap, d] as
    one batched product, scaled by their gates in bf16: [E, cap, d]."""
    gu = proj("ecd,edgf->ecgf", xs, p["wi"])
    h = F.silu(gu[:, :, 0].float()).to(xs.dtype) * gu[:, :, 1]
    ys = proj("ecf,efd->ecd", h, p["wo"])
    return ys * r["gate"][..., None].to(ys.dtype)


def combine(ys: torch.Tensor, r: dict) -> torch.Tensor:
    """[T, d] bf16: the sum of each token's kept rows of ``ys`` [E, cap,
    d], added one at a time in the order of their experts' indices and
    rounded to bf16 after each add (the reference's scatter-add)."""
    E, cap, d = ys.shape
    # a zero row at the end stands for a dropped assignment
    rows = torch.cat([ys.reshape(E * cap, d), ys.new_zeros(1, d)])
    idx = torch.where(r["kept"], r["experts"] * cap + r["rank"], E * cap)
    # each token's assignments in the order of their experts
    idx = idx.gather(1, torch.argsort(r["experts"], dim=1))
    out = rows[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out + rows[idx[:, j]]
    return out


def moe_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B,S,d] -> [B,S,d]: the routed experts' combined output, plus
    the shared experts' where the config has them."""
    m: MoECfg = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, router_logits(p, xt), m)
    out = combine(expert_ffn(p, gather(xt, r), r), r).reshape(B, S, d)
    if m.n_shared:
        gu = proj("bsd,dgf->bsgf", x, p["shared_wi"])
        h = F.silu(gu[:, :, 0].float()).to(x.dtype) * gu[:, :, 1]
        out = out + proj("bsf,fd->bsd", h, p["shared_wo"])
    return out
