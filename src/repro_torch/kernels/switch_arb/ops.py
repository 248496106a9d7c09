"""Crossbar arbitration ops: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``); there is no fallback
from one to the other.  Both give the same bits.

``switch_arbitrate_flat`` adapts the engine's flat requester table
(``[NR] = [N*P network inputs] ++ [S endpoint NICs]``) to the dense
per-switch layout the kernel works on: ``row_of`` (static, topology-only)
scatters flat rows to ``switch * r_max + row`` positions, and the results
gather back through the same map.  Dense rows not backed by a requester
keep ``route = 0`` and can never win a grant.
"""
from __future__ import annotations

import torch

from . import kernel, ref

__all__ = ["vc_prearb", "switch_arbitrate", "switch_arbitrate_flat"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no switch_arb implementation for device {t.device}")


def vc_prearb(qlen: torch.Tensor, rand: torch.Tensor):
    """VC pre-arbitration: int32 ``(sel, has)`` [N, P] from int32 ``qlen``
    and float32 ``rand`` [N, P, V]."""
    if _on_cuda(qlen):
        return kernel.vc_prearb(qlen, rand)
    return ref.vc_prearb_ref(qlen, rand)


def switch_arbitrate(occ, deroute, mask, tie, route, rnd, lo, *,
                     penalty: float):
    """Fused score evaluation + output arbitration on the dense layout."""
    fn = kernel.switch_arbitrate if _on_cuda(occ) else ref.switch_arbitrate_ref
    return fn(occ, deroute, mask, tie, route, rnd, lo, penalty=penalty)


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
