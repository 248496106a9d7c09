"""Plain PyTorch versions of the two crossbar-arbitration kernels.

One crossbar sub-round of the simulator decomposes into

1. **VC pre-arbitration** — per (switch, input port), pick one candidate
   VC among the non-empty input queues by random priority;
2. **routing-score evaluation** — per requester, score every output port
   (occupancy + deroute penalty + random tiebreak, masked to the allowed
   and credited ports) and pick the argmin;
3. **segmented output arbitration** — per (switch, output port), grant
   the single requester with the highest random priority.

Stages 2+3 run on the dense per-switch requester layout ``[N, R, ...]``
(``switch_arbitrate_ref``, the TPU kernel's own interface) or on the
engine's flat requester rows with the occupancies read from the queue
state (``switch_arbitrate_rows_ref``, what the engine runs).
All randomness is drawn by the caller and passed in, so these functions,
the CUDA kernels in ``csrc/switch_arb.cu`` and the reference's Pallas
kernels give the same bits for the same inputs.  Ties resolve to the
lowest index, as in ``jnp.argmin``/``jnp.argmax``.
"""
from __future__ import annotations

import torch

BIG = 1e9          # masked score; exactly representable in float32


def vc_prearb_ref(qlen: torch.Tensor, rand: torch.Tensor, buf=None,
                  head=None):
    """VC pre-arbitration.

    ``qlen``: int32 [N, P, V] queue lengths (any value > 0 means a
    candidate); ``rand``: float32 [N, P, V] priorities in [0, 1).
    Returns ``(sel, has)``, int32 [N, P] each: the first VC of highest
    priority among the candidates, and 0/1 whether any VC was a candidate.

    With a queue buffer ``buf`` int32 [N*P*V, depth] and its ``head``
    int32 [N*P*V], also returns ``pkt`` int32 [N, P]: the head packet of
    the chosen queue ``q = (n*P + p)*V + sel``, ``buf[q, head[q]]``, where
    ``has``, else -1.
    """
    prio = torch.where(qlen > 0, rand, -1.0)
    best, sel = prio.max(dim=-1)
    sel, has = sel.to(torch.int32), (best >= 0.0).to(torch.int32)
    if buf is None:
        return sel, has
    n, p, v = qlen.shape
    q = torch.arange(n * p, device=qlen.device) * v + sel.reshape(-1)
    hd = buf.reshape(-1)[q * buf.shape[1] + head[q]]
    pkt = torch.where(has.reshape(-1) > 0, hd, -1).reshape(n, p)
    return sel, has, pkt


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


def switch_arbitrate_rows_ref(tie, allowed, deroute, route, rnd, next_vc,
                              oq_len, qlen, *, nic_first, dq_base, d: int,
                              penalty: float, out_queue: int,
                              zero_occ: bool = False):
    """Routing-score evaluation + segmented output arbitration on the
    engine's flat requester rows ``[N*P network inputs] ++ [NICs]``.

    Inputs:
      tie       float32 [NR, P]  uniform [0, 1) score tiebreak
      allowed   bool    [NR, P]  port allowed by routing
      deroute   bool    [NR, P]  port is a Polarized deroute
      route     bool    [NR]     requester holds a routable packet
      rnd       int32   [NR]     8-bit random arbitration priority
      next_vc   int32   [NR]     flight VC, in [0, V)
      oq_len, qlen int32 [N*P*V] output / input queue lengths
      nic_first int32   [N]      first NIC row of switch n (its d NIC rows
                                 follow), -1 for a switch with none
      dq_base   int32   [N*P]    downstream input queue of (switch, port),
                                 times V
    Row ``i`` (switch ``cur``: ``i // P`` for a network input) scores port
    ``j`` with ``oq = oq_len[(cur*P + j)*V + vc]``, ``occ = oq +
    qlen[dq_base[cur*P + j] + vc]`` and ``mask = allowed & (oq <
    out_queue)``, as ``switch_arbitrate_ref`` with ``lo = i``;
    ``zero_occ`` (ksp) scores the tiebreak alone (occupancy and deroute
    0).  Returns int32 ``(port [NR], win [NR], seg [N*P])``.

    Replicas: every input but the geometry (``nic_first``, ``dq_base``)
    may carry a leading ``[R]`` axis, and so do the outputs.  Replica
    ``r`` is arbitrated alone, with the row index ``i`` within its own
    fabric in its priority words, so it is bitwise the unbatched call
    on its slices.
    """
    batched = tie.dim() == 3
    if not batched:
        tie, allowed, deroute, route, rnd, next_vc, oq_len, qlen = (
            x.unsqueeze(0) for x in (tie, allowed, deroute, route, rnd,
                                     next_vc, oq_len, qlen))
    r, nr, p = tie.shape
    n = nic_first.shape[0]
    nq = oq_len.shape[1]
    v = nq // (n * p)
    dev = tie.device
    # every row's switch: network inputs by their index, NICs by nic_first
    cur = torch.arange(nr, device=dev) // p
    leaves = (nic_first >= 0).nonzero().reshape(-1)
    nic_rows = (nic_first[leaves].long()[:, None]
                + torch.arange(d, device=dev)).reshape(-1)
    cur[nic_rows] = leaves.repeat_interleave(d)
    # flat offsets of each replica's queue words and output ports
    rep = torch.arange(r, device=dev)[:, None, None]
    vc = next_vc.long()[..., None]                               # [R, NR, 1]
    sp = (cur * p)[:, None] + torch.arange(p, device=dev)        # [NR, P]
    oq = oq_len.reshape(-1)[rep * nq + sp * v + vc]
    occ = oq + qlen.reshape(-1)[rep * nq + dq_base.long()[sp] + vc]
    mask = allowed & (oq < out_queue)
    der = deroute
    if zero_occ:        # random walk: the score is the tiebreak alone
        occ = torch.zeros_like(occ)
        der = torch.zeros_like(der)
    score = occ.to(torch.float32) + penalty * der.to(torch.float32) + tie
    score = torch.where(mask, score, BIG)
    best, port = score.min(dim=-1)
    can = route & (best < BIG)
    lo = torch.arange(nr, dtype=torch.int32, device=dev)
    prio = torch.where(can, (rnd << 23) | lo, -1)
    key = rep[..., 0] * (n * p) + cur * p + port                  # [R, NR]
    seg = torch.full((r * n * p,), -1, dtype=torch.int32, device=dev)
    seg.scatter_reduce_(0, key.reshape(-1), prio.reshape(-1), reduce="amax")
    win = can & (seg[key] == prio)
    out = (port.to(torch.int32), win.to(torch.int32), seg.reshape(r, n * p))
    return out if batched else tuple(x[0] for x in out)
