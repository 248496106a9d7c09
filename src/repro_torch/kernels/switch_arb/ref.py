"""Plain PyTorch versions of the two crossbar-arbitration kernels.

One crossbar sub-round of the simulator decomposes into

1. **VC pre-arbitration** — per (switch, input port), pick one candidate
   VC among the non-empty input queues by random priority;
2. **routing-score evaluation** — per requester, score every output port
   (occupancy + deroute penalty + random tiebreak, masked to the allowed
   and credited ports) and pick the argmin;
3. **segmented output arbitration** — per (switch, output port), grant
   the single requester with the highest random priority.

Stages 2+3 run on the dense per-switch requester layout ``[N, R, ...]``.
All randomness is drawn by the caller and passed in, so these functions,
the CUDA kernels in ``csrc/switch_arb.cu`` and the reference's Pallas
kernels give the same bits for the same inputs.  Ties resolve to the
lowest index, as in ``jnp.argmin``/``jnp.argmax``.
"""
from __future__ import annotations

import torch

BIG = 1e9          # masked score; exactly representable in float32


def vc_prearb_ref(qlen: torch.Tensor, rand: torch.Tensor):
    """VC pre-arbitration.

    ``qlen``: int32 [N, P, V] queue lengths (any value > 0 means a
    candidate); ``rand``: float32 [N, P, V] priorities in [0, 1).
    Returns ``(sel, has)``, int32 [N, P] each: the first VC of highest
    priority among the candidates, and 0/1 whether any VC was a candidate.
    """
    prio = torch.where(qlen > 0, rand, -1.0)
    best, sel = prio.max(dim=-1)
    return sel.to(torch.int32), (best >= 0.0).to(torch.int32)


def switch_arbitrate_ref(occ, deroute, mask, tie, route, rnd, lo, *,
                         penalty: float):
    """Fused routing-score evaluation + segmented output arbitration.

    Inputs (dense per-switch layout, ``R`` requester rows per switch):
      occ     int32   [N, R, P]  congestion (output queue + downstream queue)
      deroute int32   [N, R, P]  0/1 — port is a Polarized deroute
      mask    int32   [N, R, P]  0/1 — port allowed by routing AND credited
      tie     float32 [N, R, P]  uniform [0, 1) score tiebreak
      route   int32   [N, R]     0/1 — requester holds a routable packet
      rnd     int32   [N, R]     8-bit random arbitration priority
      lo      int32   [N, R]     unique low bits (flat requester index)

    Returns ``(port, win, seg)``: int32 [N, R] chosen output port, int32
    [N, R] 0/1 grant, and int32 [N, P] winning priority word per output
    port (-1 = no grant; its low 23 bits are the winner's ``lo``).
    """
    score = (occ.to(torch.float32) + penalty * deroute.to(torch.float32)
             + tie)
    score = torch.where(mask > 0, score, BIG)
    best, port = score.min(dim=-1)
    port = port.to(torch.int32)
    can = (route > 0) & (best < BIG)
    prio = torch.where(can, (rnd << 23) | lo, -1)
    seg = torch.full(occ.shape[:1] + occ.shape[2:], -1, dtype=torch.int32,
                     device=occ.device)
    seg.scatter_reduce_(1, port.long(), prio, reduce="amax")
    win = can & (seg.gather(1, port.long()) == prio)
    return port, win.to(torch.int32), seg
