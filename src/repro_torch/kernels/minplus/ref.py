"""Plain PyTorch versions of the tropical (min, +) matrix product.

``C[i, j] = min(INF, min_k (A[i, k] + B[k, j]))`` is the inner product
of the (min, +) semiring.  Powering the hop-weighted adjacency matrix
under it gives all-pairs hop distances: the device-side form of the
routing tables' distance computation (``repro_torch.core.routing``).

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
           "all_pairs_ref"]

INF = 1e9          # "no path"; exactly representable in float32

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
