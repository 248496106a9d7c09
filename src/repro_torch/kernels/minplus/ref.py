"""Plain PyTorch versions of the tropical (min, +) matrix product.

``C[i, j] = min(INF, min_k (A[i, k] + B[k, j]))`` is the inner product
of the (min, +) semiring.  Powering the hop-weighted adjacency matrix
under it gives all-pairs hop distances: the device-side form of the
routing tables' distance computation (``repro_torch.core.routing``).

The int16 form (:func:`minplus_hops_ref`) takes hop counts with
``HOPS_INF`` as "no path" and A given k-major, as the CUDA kernel on
Hopper's DPX instructions does; on finite entries below ``HOPS_LIMIT`` it
gives :func:`minplus_ref`'s result exactly.

The cap at ``INF`` is the TPU kernel's, not its pure-jnp oracle's: the
Pallas kernel starts its accumulator at ``INF`` and pads with ``INF``,
so a pair with no finite path comes out as ``INF``, where the oracle
gives the raw sum (up to ``2 * INF``).  These versions and the CUDA
kernel in ``csrc/minplus.cu`` follow the kernel.  Every add is one
float32 rounding and ``min`` is exact, so the result does not depend on
the order of the reduction.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["INF", "minplus_ref", "adjacency_matrix", "minplus_powers",
           "all_pairs_ref", "HOPS_INF", "HOPS_LIMIT", "minplus_hops_ref",
           "padded_hops", "hops_adjacency"]

INF = 1e9          # "no path"; exactly representable in float32

# "no path" of the int16 form: S + S still fits an int16, and finite
# entries below HOPS_LIMIT keep every finite sum below S
HOPS_INF = 0x3FFF
HOPS_LIMIT = (HOPS_INF + 1) // 2     # 8,192

# elements of the [M, k_chunk, N] temporary of one reduction step
_CHUNK_ELEMS = 1 << 24


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` [M, K] (min, +) ``b`` [K, N] -> [M, N], capped at
    ``INF``.  K is reduced in chunks, so the temporary is
    ``[M, k_chunk, N]`` and never ``[M, K, N]``."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    out = torch.full((m, n), INF, dtype=torch.float32, device=a.device)
    step = max(1, _CHUNK_ELEMS // max(1, m * n))
    for k0 in range(0, k, step):
        blk = (a[:, k0:k0 + step, None] + b[None, k0:k0 + step, :]).amin(1)
        out = torch.minimum(out, blk)
    return out


def adjacency_matrix(nbrs, inf: float = INF, *, device=None) -> torch.Tensor:
    """Padded neighbour array [N, P] -> dense float32 hop-weight adjacency
    [N, N] (0 on the diagonal, 1 per link, ``inf`` elsewhere), built on
    ``device``."""
    nbrs = np.asarray(nbrs)
    n, p = nbrs.shape
    m = torch.full((n, n), inf, dtype=torch.float32, device=device)
    m.fill_diagonal_(0.0)
    ok = nbrs >= 0
    rows = torch.as_tensor(np.repeat(np.arange(n), p)[ok.ravel()],
                           device=device)
    cols = torch.as_tensor(nbrs[ok].astype(np.int64), device=device)
    m[rows, cols] = 1.0
    return m


def minplus_powers(d: torch.Tensor, product=minplus_ref, *,
                   n_iters=None, max_pow: int = 16):
    """Square ``d`` under ``product`` (``minplus_ref``, or the op that
    picks the kernel by device): ``n_iters`` times, or with ``n_iters``
    None until a squaring changes nothing (at most ``max_pow``
    squarings).  Returns ``(d, squarings)``; the fixpoint test costs one
    host sync per squaring."""
    squarings = 0
    for _ in range(max_pow if n_iters is None else n_iters):
        nd = product(d, d)
        squarings += 1
        if n_iters is None and torch.equal(nd, d):
            break
        d = nd
    return d, squarings


def all_pairs_ref(adj: torch.Tensor, max_pow: int = 16) -> torch.Tensor:
    """Repeated min-plus squaring to the shortest-path fixpoint."""
    return minplus_powers(adj, max_pow=max_pow)[0]


def minplus_hops_ref(at: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int16 ``at`` [K, M] (A given k-major) (min, +) ``b`` [K, N] ->
    int16 [M, N]: ``C[i, j] = min(S, min_k at[k, i] + b[k, j])`` with
    ``S = HOPS_INF``.  Sums are int32, K is reduced in chunks as in
    :func:`minplus_ref`.  On entries in ``[0, HOPS_LIMIT) + {S}`` this is
    :func:`minplus_ref` exactly, under ``v <-> float(v)`` and
    ``S <-> INF``."""
    k, m = at.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: {tuple(at.shape)}^T x "
                         f"{tuple(b.shape)}")
    out = torch.full((m, n), HOPS_INF, dtype=torch.int32, device=at.device)
    step = max(1, _CHUNK_ELEMS // max(1, m * n))
    for k0 in range(0, k, step):
        blk = (at[k0:k0 + step, :, None].int()
               + b[k0:k0 + step, None, :].int()).amin(0)
        out = torch.minimum(out, blk)
    return out.clamp_max_(HOPS_INF).to(torch.int16)


def padded_hops(rows: int, cols: int, *, device=None) -> torch.Tensor:
    """A ``[rows, cols]`` int16 view, filled with ``HOPS_INF``, of a buffer
    whose rows are padded to a multiple of 8 entries (16 bytes): the row
    layout the CUDA kernel takes for every operand and output."""
    ld = max(8, -(-cols // 8) * 8)
    return torch.full((rows, ld), HOPS_INF, dtype=torch.int16,
                      device=device)[:, :cols]


def hops_adjacency(nbrs, *, device=None) -> torch.Tensor:
    """Padded neighbour array [N, P] -> int16 hop adjacency [N, N] (0 on
    the diagonal, 1 per link, ``HOPS_INF`` elsewhere) as a
    :func:`padded_hops` view on ``device``."""
    nbrs = np.asarray(nbrs)
    n, p = nbrs.shape
    m = padded_hops(n, n, device=device)
    m.diagonal().fill_(0)
    ok = nbrs >= 0
    rows = torch.as_tensor(np.repeat(np.arange(n), p)[ok.ravel()],
                           device=device)
    cols = torch.as_tensor(nbrs[ok].astype(np.int64), device=device)
    m[rows, cols] = 1
    return m
