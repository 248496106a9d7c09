"""Mixture-of-Experts FFN: routing, capacity, experts, combine.

The port of the reference's ``models/moe.py``.  On one device its
expert-parallel split has one rank (``n_tp = n_dp = 1``): every token is
routed among all ``E`` experts.  A model laid out over ranks (DTensor
activations) splits tokens over ``dp`` and experts over ``tp`` under
``local_map``, as the reference's ``shard_map`` (:func:`moe_apply`).

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

from ..parallel.sharding import as_dtensor, is_dtensor
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


def _local_experts(p: dict, xt: torch.Tensor, m: MoECfg, e0: int,
                   wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The routed experts ``e0 .. e0 + E_loc - 1`` (whose weights are
    ``wi``, ``wo`` [E_loc, ...]) on the tokens xt [T, d]: every token is
    routed among all ``E`` experts, each of these takes its first ``cap``
    assignments (``cap`` from ``T``), and each token's rows from these
    experts are added as :func:`combine` adds them, the others' rows
    left out: [T, d], the part of the output these experts give."""
    r = route(p, router_logits(p, xt), m)
    e_loc = wi.shape[0]
    mine = {"tok": r["tok"][e0:e0 + e_loc], "gate": r["gate"][e0:e0 + e_loc]}
    ys = expert_ffn({"wi": wi, "wo": wo}, gather(xt, mine), mine)
    local = (r["experts"] >= e0) & (r["experts"] < e0 + e_loc)
    return combine(ys, dict(r, experts=torch.where(local, r["experts"] - e0,
                                                   e_loc),
                            kept=r["kept"] & local))


def _split_experts(p: dict, x, cfg, sh):
    """The reference's ``shard_map`` of the routed experts on a DTensor x
    [B,S,d]: tokens split over ``dp``, experts over ``tp``.  Each rank
    routes its own tokens (so ``cap`` comes from its token count) and
    runs its ``E / n_tp`` experts; its output is a partial sum over
    ``tp`` (``Partial``), which DTensor reduces where it is next used, as
    the reference's ``psum``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m: MoECfg = cfg.moe
    dm = x.device_mesh
    names = dm.mesh_dim_names
    tp, dp = sh.rules.tp, tuple(sh.rules.dp)
    n_tp = dm.size(names.index(tp)) if tp else 1
    if m.n_experts % n_tp:
        raise ValueError(f"{m.n_experts} experts do not split over "
                         f"{n_tp} ranks of {tp!r}")
    e0 = dm.get_local_rank(tp) * (m.n_experts // n_tp) if n_tp > 1 else 0

    def along(dp_p, tp_p):
        return [Replicate() if dm.size(i) == 1 else dp_p if a in dp
                else tp_p if a == tp else Replicate()
                for i, a in enumerate(names)]
    split_x = along(Shard(0), Replicate())
    rep = along(Replicate(), Replicate())
    split_e = along(Replicate(), Shard(0))
    # gradients: x's a partial sum over the experts' split, the router's
    # over both splits, the experts' over the tokens' split
    grads = (along(Shard(0), Partial()), along(Partial(), Partial()),
             along(Partial(), Partial()), along(Partial(), Shard(0)),
             along(Partial(), Shard(0)))
    bias = p.get("router_bias")

    def local(x_loc, router, router_bias, wi, wo):
        B, S, d = x_loc.shape
        q = {"router": router}
        if router_bias is not None:
            q["router_bias"] = router_bias
        return _local_experts(q, x_loc.reshape(B * S, d), m, e0, wi,
                              wo).reshape(B, S, d)
    return local_map(
        local, out_placements=along(Shard(0), Partial()),
        in_placements=(split_x, rep, None if bias is None else rep,
                       split_e, split_e),
        in_grad_placements=grads[:2] + (None if bias is None else grads[2],)
        + grads[3:],
        device_mesh=dm, redistribute_inputs=True)(
            x, *(as_dtensor(t, dm) for t in (p["router"], bias, p["wi"],
                                             p["wo"])))


def moe_apply(p: dict, x: torch.Tensor, cfg, sh=None) -> torch.Tensor:
    """x: [B,S,d] -> [B,S,d]: the routed experts' combined output, plus
    the shared experts' where the config has them.  A DTensor x (a model
    laid out over ranks by ``sh``) splits the experts as the reference's
    ``shard_map`` does (:func:`_split_experts`)."""
    m: MoECfg = cfg.moe
    B, S, d = x.shape
    if is_dtensor(x):
        out = _split_experts(p, x, cfg, sh)
    else:
        xt = x.reshape(B * S, d)
        r = route(p, router_logits(p, xt), m)
        out = combine(expert_ffn(p, gather(xt, r), r), r).reshape(B, S, d)
    if m.n_shared:
        gu = proj("bsd,dgf->bsgf", x, p["shared_wi"])
        h = F.silu(gu[:, :, 0].float()).to(x.dtype) * gu[:, :, 1]
        out = out + proj("bsf,fd->bsd", h, p["shared_wo"])
    return out
