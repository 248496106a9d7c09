"""Crossbar arbitration ops: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  Both give the same bits.

The engine runs ``vc_prearb`` (with its head-packet gather) and
``switch_arbitrate_rows``, which works on the engine's flat requester
rows.  ``switch_arbitrate`` is the TPU kernel's dense ``[N, R, P]``
interface; ``switch_arbitrate_flat`` adapts the flat rows to it:
``row_of`` (static, topology-only) scatters flat rows to
``switch * r_max + row`` positions, and the results gather back through
the same map.  Dense rows not backed by a requester keep ``route = 0``
and can never win a grant.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernel, ref

__all__ = ["vc_prearb", "switch_arbitrate", "switch_arbitrate_flat",
           "switch_arbitrate_rows", "flat_rows_geometry"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no switch_arb implementation for device {t.device}")


def vc_prearb(qlen: torch.Tensor, rand: torch.Tensor, buf=None, head=None):
    """VC pre-arbitration: int32 ``(sel, has)`` [N, P] from int32 ``qlen``
    and float32 ``rand`` [N, P, V]; with ``buf`` and ``head`` also the
    chosen queue's head packet ``pkt`` [N, P] (-1 where none)."""
    if _on_cuda(qlen):
        return kernel.vc_prearb(qlen, rand, buf, head)
    return ref.vc_prearb_ref(qlen, rand, buf, head)


def switch_arbitrate(occ, deroute, mask, tie, route, rnd, lo, *,
                     penalty: float):
    """Fused score evaluation + output arbitration on the dense layout."""
    fn = kernel.switch_arbitrate if _on_cuda(occ) else ref.switch_arbitrate_ref
    return fn(occ, deroute, mask, tie, route, rnd, lo, penalty=penalty)


def switch_arbitrate_rows(tie, allowed, deroute, route, rnd, next_vc,
                          oq_len, qlen, *, nic_first, dq_base, d: int,
                          penalty: float, out_queue: int,
                          zero_occ: bool = False):
    """Occupancy, credit, scores and output arbitration on the engine's
    flat requester rows: int32 ``(port [NR], win [NR], seg [N*P])`` (see
    ``ref.switch_arbitrate_rows_ref``).  Both devices check their inputs
    alike (``kernel.rows_geometry``)."""
    args = (tie, allowed, deroute, route, rnd, next_vc, oq_len, qlen)
    kw = dict(nic_first=nic_first, dq_base=dq_base, d=d, penalty=penalty,
              out_queue=out_queue, zero_occ=zero_occ)
    if _on_cuda(tie):
        return kernel.switch_arbitrate_rows(*args, **kw)
    kernel.rows_geometry(*args, nic_first, dq_base, d)
    return ref.switch_arbitrate_rows_ref(*args, **kw)


def flat_rows_geometry(nbrs, nbr_port, leaf_ids, d: int, v: int):
    """The static geometry ``switch_arbitrate_rows`` reads, from a
    topology's ``nbrs`` / ``nbr_port`` [N, P] (-1: no link) and
    ``leaf_ids``: int32 ``(nic_first [N], dq_base [N*P])`` numpy arrays.

    The flat rows are ``[N*P network inputs] ++ [NICs]``, leaf rank r's
    d NICs at rows ``N*P + r*d ...``, so ``nic_first[leaf_ids[r]] = N*P +
    r*d`` and -1 elsewhere.  Output port (n, j) feeds the downstream input
    queues ``dq_base[n*P + j] + vc``; a port with no link points at queue
    (0, 0) as the reference's ``_dq_perm`` does (its score is masked).
    """
    nbrs, nbr_port = np.asarray(nbrs), np.asarray(nbr_port)
    n, p = nbrs.shape
    nic_first = np.full(n, -1, np.int64)
    nic_first[np.asarray(leaf_ids)] = n * p + np.arange(len(leaf_ids)) * d
    dq_base = (np.maximum(nbrs, 0) * p + np.maximum(nbr_port, 0)) * v
    return (nic_first.astype(np.int32),
            dq_base.reshape(-1).astype(np.int32))


def switch_arbitrate_flat(occ, deroute, mask, tie, route, rnd, lo, *,
                          penalty: float, row_of: torch.Tensor,
                          n_switches: int, r_max: int):
    """Flat-requester adapter: ``[NR, ...]`` int32 / float32 in,
    ``(port, win)`` back as flat int32 ``[NR]`` vectors plus ``seg``
    flattened to ``[N * P]`` (the engine's ``switch * P + port`` layout).

    ``row_of`` is the static flat-row -> dense-row map (int64 [NR],
    injective, values < n_switches * r_max).
    """
    n_rows = n_switches * r_max

    def den(x, fill):
        out = torch.full((n_rows,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        out[row_of] = x
        return out.reshape((n_switches, r_max) + tuple(x.shape[1:]))

    port, win, seg = switch_arbitrate(
        den(occ, 0), den(deroute, 0), den(mask, 0), den(tie, 0.0),
        den(route, 0), den(rnd, 0), den(lo, 0), penalty=penalty)
    return (port.reshape(-1)[row_of], win.reshape(-1)[row_of],
            seg.reshape(-1))
