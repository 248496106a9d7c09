"""LM-request -> workload-program bridge.

The port's copy of the reference's ``repro.serving.bridge``, program for
program.  Compiles an LM inference request (an architecture from
``repro_torch.configs`` plus a serving phase) into the
:class:`repro_torch.workloads.WorkloadProgram` its fabric traffic
reduces to:

* ``prefill`` — the tensor-parallel all-gather of the prompt's sharded
  activations: a ring over ``ranks`` ranks, ``ranks - 1`` phases, each
  shifting one shard of ``ceil(tokens / ranks) * d_model`` activation
  bytes to the next neighbour.
* ``decode``  — per-token point-to-point: each rank ships one token's
  ``d_model`` activation vector to its stage peer
  (``(r + ranks // 2) mod ranks``), one phase.
* ``moe``     — expert-parallel All2All from the architecture's
  ``MoECfg`` shapes: every rank exchanges its capacity-bounded
  routed-token slice (``tokens_local * top_k / ranks *
  capacity_factor``) with every other rank via the shifted exchange,
  ``ranks - 1`` phases.

Bytes lower to packets through :data:`PACKET_BYTES` (one 16-flit packet,
the engine's slot serialization unit).  The three structural builders are
registered with :func:`repro_torch.workloads.register_program_builder`
under ``lm_prefill`` / ``lm_decode`` / ``lm_moe`` at import (once: a
name already registered is left as it is), so ``WorkloadSpec``
gains serving vocabulary for free (``pattern="lm_moe", ranks=..,
vec_packets=..``) and the runner executes them device-resident like any
collective.  :func:`request_to_program` / :func:`request_to_spec` derive
``ranks`` / ``vec_packets`` from the real model shapes.

Structural builders are numpy-only; ``repro_torch.configs`` is imported
lazily, only when a request names an architecture.
"""
from __future__ import annotations

import math

import numpy as np

from ..workloads.ir import WorkloadProgram
from ..workloads.programs import PROGRAM_BUILDERS, register_program_builder

__all__ = [
    "PACKET_BYTES",
    "SERVING_PHASES",
    "lm_prefill_program",
    "lm_decode_program",
    "lm_moe_program",
    "request_to_program",
    "request_to_spec",
]

# one slot serializes one 16-flit packet; 16 B flits -> 256 B per packet
PACKET_BYTES = 256
# bf16 activations (2 bytes/element), the serving dtype of the seed stack
ACT_BYTES = 2

SERVING_PHASES = ("prefill", "decode", "moe")


def _check_ranks(name: str, S: int, ranks: int) -> None:
    if ranks < 2:
        raise ValueError(f"{name} needs ranks >= 2, got {ranks}")
    if ranks > S:
        raise ValueError(f"{name}: ranks {ranks} > endpoints {S}")


def _fill_program(name: str, S: int, ranks: int,
                  rank_partner: np.ndarray, packets: int) -> WorkloadProgram:
    """Lower rank-level phases onto S endpoints: ranks map identity onto
    the first ``ranks`` endpoints, the rest are self-partnered with the
    same per-phase size (local fast-path delivery) — the same layout the
    allreduce builders use, so completion semantics match."""
    n_phases = rank_partner.shape[0]
    partner = np.tile(np.arange(S, dtype=np.int64), (n_phases, 1))
    partner[:, :ranks] = rank_partner
    return WorkloadProgram(
        name=name, partner=partner,
        packets=np.full((n_phases, S), packets, np.int64))


def lm_prefill_program(S: int, ranks: int, packets: int) -> WorkloadProgram:
    """Ring all-gather: phase ``p`` sends rank ``r``'s current shard to
    ``(r + 1) mod ranks``; ``ranks - 1`` phases of ``packets`` each."""
    _check_ranks("lm_prefill", S, ranks)
    r = np.arange(ranks, dtype=np.int64)
    rank_partner = np.tile((r + 1) % ranks, (ranks - 1, 1))
    return _fill_program(f"lm_prefill[{ranks}x{packets}]", S, ranks,
                         rank_partner, packets)


def lm_decode_program(S: int, ranks: int, packets: int) -> WorkloadProgram:
    """Decode point-to-point: one phase, rank ``r`` ships its token
    activations to stage peer ``(r + ranks // 2) mod ranks`` (the
    cross-fabric pipeline hop)."""
    _check_ranks("lm_decode", S, ranks)
    r = np.arange(ranks, dtype=np.int64)
    rank_partner = ((r + ranks // 2) % ranks)[None, :]
    return _fill_program(f"lm_decode[{ranks}x{packets}]", S, ranks,
                         rank_partner, packets)


def lm_moe_program(S: int, ranks: int, packets: int) -> WorkloadProgram:
    """Expert-parallel All2All: shifted exchange, phase ``p`` pairs rank
    ``r`` with ``(r + p + 1) mod ranks``; ``packets`` = one rank-pair
    routed-token slice."""
    _check_ranks("lm_moe", S, ranks)
    r = np.arange(ranks, dtype=np.int64)
    rank_partner = np.stack([(r + p + 1) % ranks for p in range(ranks - 1)])
    return _fill_program(f"lm_moe[{ranks}x{packets}]", S, ranks,
                         rank_partner, packets)


_STRUCTURAL = {"prefill": lm_prefill_program, "decode": lm_decode_program,
               "moe": lm_moe_program}


def _default_ranks(S: int) -> int:
    """Largest power of two <= min(S, 8): a typical tensor-parallel degree
    that always fits the fabric."""
    return 1 << (min(S, 8).bit_length() - 1)


def _make_builder(phase: str):
    structural = _STRUCTURAL[phase]

    def build(S: int, *, ranks: int = 0, vec_packets: int = 16,
              **_kw) -> WorkloadProgram:
        return structural(S, ranks or _default_ranks(S), vec_packets)
    return build


for _phase in SERVING_PHASES:
    # WorkloadSpec vocabulary: pattern="lm_prefill" | "lm_decode" | "lm_moe"
    # (idempotent: a reload of this module keeps the first registration)
    if f"lm_{_phase}" not in PROGRAM_BUILDERS:
        register_program_builder(f"lm_{_phase}", _make_builder(_phase))


def _packets(nbytes: float) -> int:
    return max(1, math.ceil(nbytes / PACKET_BYTES))


def request_phase_shape(cfg, phase: str, *, ranks: int,
                        tokens: int = 256, batch: int = 1) -> dict:
    """Per-phase traffic shape of one request on ``cfg``: the per-endpoint
    message size in packets plus the derivation (bytes, phases).

    * ``prefill``: one prompt shard — ``ceil(tokens / ranks) * d_model``
      activations per phase of the ring all-gather.
    * ``decode``: one token — ``d_model`` activations, times ``batch``
      decoding requests sharing the step.
    * ``moe``: one rank pair's routed tokens —
      ``tokens_local * top_k / ranks`` capacity-scaled, times ``d_model``.
    """
    if phase not in SERVING_PHASES:
        raise ValueError(f"unknown serving phase {phase!r}; expected one "
                         f"of {SERVING_PHASES}")
    if tokens < 1 or batch < 1:
        raise ValueError(f"tokens and batch must be >= 1, got "
                         f"tokens={tokens} batch={batch}")
    d = cfg.d_model
    if phase == "prefill":
        shard = math.ceil(tokens / ranks)
        nbytes = shard * d * ACT_BYTES * batch
        n_phases = ranks - 1
    elif phase == "decode":
        nbytes = d * ACT_BYTES * batch
        n_phases = 1
    else:  # moe
        m = cfg.moe
        if m is None:
            raise ValueError(
                f"arch {cfg.name!r} has no MoE block: the moe phase needs "
                "an expert-parallel architecture")
        t_loc = max(1, math.ceil(tokens * batch / ranks))
        per_pair = max(1.0, t_loc * m.top_k / ranks * m.capacity_factor)
        nbytes = per_pair * d * ACT_BYTES
        n_phases = ranks - 1
    return {"phase": phase, "ranks": ranks, "d_model": d,
            "bytes_per_phase": int(math.ceil(nbytes)),
            "packets": _packets(nbytes), "n_phases": n_phases}


def _resolve_cfg(model):
    if isinstance(model, str):
        from ..configs import get_config   # heavy import, deferred
        return get_config(model)
    return model


def request_to_program(model, phase: str, S: int, *, ranks: int = 0,
                       tokens: int = 256, batch: int = 1) -> WorkloadProgram:
    """Compile one LM inference request into a workload program.

    ``model`` is an arch id (resolved via ``repro_torch.configs``,
    lazily) or a ``ModelConfig``; ``phase`` is ``prefill`` / ``decode``
    / ``moe``;
    ``S`` the fabric's endpoint count.  ``ranks=0`` picks the default
    tensor-parallel degree."""
    cfg = _resolve_cfg(model)
    n = ranks or _default_ranks(S)
    shape = request_phase_shape(cfg, phase, ranks=n, tokens=tokens,
                                batch=batch)
    return _STRUCTURAL[phase](S, n, shape["packets"])


def request_to_spec(model, phase: str, S: int, *, ranks: int = 0,
                    tokens: int = 256, batch: int = 1):
    """The :class:`repro_torch.api.WorkloadSpec` equivalent of
    :func:`request_to_program` — declarative, JSON-serializable, and
    executed device-resident by the runner through the registered
    ``lm_*`` builders."""
    from ..api.specs import WorkloadSpec   # avoid a cycle at import time
    cfg = _resolve_cfg(model)
    n = ranks or _default_ranks(S)
    shape = request_phase_shape(cfg, phase, ranks=n, tokens=tokens,
                                batch=batch)
    return WorkloadSpec(pattern=f"lm_{phase}", ranks=n,
                        vec_packets=shape["packets"])
