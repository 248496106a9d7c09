"""Plain PyTorch version of the selective-scan kernel.

The Mamba-1 recurrence, one time step at a time, in the order of the
hand-written kernel in ``csrc/selective_scan.cu``:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = sum_n h_t[n] * C_t[n]

with every product and sum one float32 rounding (no fused multiply-add)
and the sum over the state taken as a halving tree, ``v[:N/2] + v[N/2:]``
until one value is left: the order of the kernel's warp shuffles.  So
the kernel can match this version bit for bit.  The reference's Pallas
kernel (``repro/kernels/selective_scan/kernel.py``) computes the same
recurrence with a sequential sum over the state.

``selective_scan_bwd_ref`` is the plain version of the backward kernel
in ``csrc/selective_scan_bwd.cu``, in its order: the states rebuilt from
the ones at sub-chunk starts, the walk back one step at a time, and the
sums over channels and batch rows in the kernel's fixed order, which
depends on its block width ``BWD_CHANNELS``.
"""
from __future__ import annotations

import torch

__all__ = ["check_shapes", "selective_scan_ref", "selective_scan_bwd_ref",
           "state_sum", "chunk_starts", "rebuild_states", "CHUNK_STEPS",
           "SUB_STEPS", "BWD_CHANNELS", "WARP_CHANNELS", "scan_work",
           "scan_bwd_work"]

CHUNK_STEPS = 64       # steps a staged run of either kernel holds
SUB_STEPS = 8          # steps between the states the backward keeps
BWD_CHANNELS = 64      # channels a block of the backward kernel
WARP_CHANNELS = 8      # channels a warp of it (4 states a lane)


def check_shapes(u, dt, A, Bc, Cc, h0) -> None:
    """Raise on shapes the kernel and this version do not take."""
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u and dt must be [B,T,Di] of one shape, got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}")
    B, T, Di = u.shape
    N = A.shape[-1]
    want = {"A": (Di, N), "Bc": (B, T, N), "Cc": (B, T, N), "h0": (B, Di, N)}
    for name, t in (("A", A), ("Bc", Bc), ("Cc", Cc), ("h0", h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")


def scan_work(b: int, t: int, di: int, n: int) -> dict:
    """The work of one launch of the scan kernel: ``{"flops": 7 float32
    operations, "ex2": one exponential, a (b, t, channel, state);
    "bytes": u, dt, A, B, C, h0 read once and y, h_T written once, all
    float32}``."""
    elems = b * t * di * n
    return {"flops": 7 * elems, "ex2": elems,
            "bytes": 4 * (3 * b * t * di + di * n + 2 * b * t * n
                          + 2 * b * di * n)}


def scan_bwd_work(b: int, t: int, di: int, n: int) -> dict:
    """:func:`scan_work` of one launch of the backward kernel: 18 float32
    operations (4 to rebuild the state, 14 to walk back) and two
    exponentials a (b, t, channel, state); u, dt, dy, A, B, C, h0, dh_T
    read once and du, ddt, dA, dB, dC, dh0 written once."""
    elems = b * t * di * n
    return {"flops": 18 * elems, "ex2": 2 * elems,
            "bytes": 4 * (5 * b * t * di + 2 * di * n + 4 * b * t * n
                          + 3 * b * di * n)}


def state_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a halving tree (the kernel's order while
    the length is even), then left to right."""
    while x.shape[-1] > 1 and x.shape[-1] % 2 == 0:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def selective_scan_ref(u, dt, A, Bc, Cc, h0):
    """u, dt: [B,T,Di]; A: [Di,N]; Bc, Cc: [B,T,N]; h0: [B,Di,N].

    Returns (y [B,T,Di], h_T [B,Di,N]), float32."""
    check_shapes(u, dt, A, Bc, Cc, h0)
    u, dt, A, Bc, Cc = (t.float() for t in (u, dt, A, Bc, Cc))
    h = h0.float()
    y = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    for t in range(u.shape[1]):
        dt_t = dt[:, t]                                         # [B,Di]
        da = torch.exp(dt_t[..., None] * A)                     # [B,Di,N]
        dbu = (dt_t * u[:, t])[..., None]
        h = da * h + dbu * Bc[:, t, None, :]
        y[:, t] = state_sum(h * Cc[:, t, None, :])
    return y, h


def _chunk_sum(x: torch.Tensor, width: int) -> torch.Tensor:
    """Sum over axis -2 of ``x`` [..., C, N] as the backward kernel sums
    over channels (zeros past C): each warp's 8 channels as a balanced
    tree, ``((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))``, then the
    warps of each block of ``width`` channels left to right, then the
    blocks left to right."""
    c, n = x.shape[-2:]
    blocks = -(-c // width)
    x = torch.nn.functional.pad(x, (0, 0, 0, blocks * width - c))
    x = x.reshape(*x.shape[:-2], blocks, width // WARP_CHANNELS,
                  WARP_CHANNELS, n)
    while x.shape[-2] > 1:
        x = x[..., 0::2, :] + x[..., 1::2, :]
    x = x[..., 0, :]                              # [..., blocks, warps, N]
    part = x[..., 0, :]
    for w in range(1, x.shape[-2]):
        part = part + x[..., w, :]
    out = part[..., 0, :]
    for k in range(1, blocks):
        out = out + part[..., k, :]
    return out


def _step(u, dt, A, Bc, h, t):
    """(a_t, h_t) from h_{t-1}: the forward's operations."""
    da = torch.exp(dt[:, t, :, None] * A)
    return da, da * h + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]


def chunk_starts(u, dt, A, Bc, h0) -> list:
    """The state before every ``SUB_STEPS``-th step (``h0`` first), as
    the backward kernel's first pass keeps them."""
    h, out = h0.float(), []
    for t in range(u.shape[1]):
        if t % SUB_STEPS == 0:
            out.append(h)
        h = _step(u, dt, A, Bc, h, t)[1]
    return out


def rebuild_states(u, dt, A, Bc, h, t0: int, t1: int) -> tuple:
    """(``[h_{t0-1}, ..., h_{t1-1}]``, ``[a_{t0}, ..., a_{t1-1}]``): the
    states and decay factors of steps ``t0 .. t1-1`` rebuilt from the
    state ``h`` before step ``t0``, bit for bit the forward's."""
    hs, das = [h], []
    for t in range(t0, t1):
        da, h = _step(u, dt, A, Bc, h, t)
        hs.append(h)
        das.append(da)
    return hs, das


def selective_scan_bwd_ref(u, dt, A, Bc, Cc, h0, dy, dh_T=None):
    """The gradient of :func:`selective_scan_ref`'s ``(y, h_T)`` for the
    cotangents ``dy`` [B,T,Di] and ``dh_T`` [B,Di,N] (None: zeros).

    Returns ``(du, ddt, dA, dB, dC, dh0)``, float32, shaped as the
    inputs.  With ``g_t = dL/dh_t`` (``g_t = dy_t C_t + a_{t+1} g_{t+1}``,
    ``a_t = exp(dt_t A)``, ``g_T`` taking ``dh_T``) and
    ``q_t = (a_t g_t) h_{t-1}``, each step back computes, one float32
    rounding an operation::

        s = state_sum(g B)        du  = dt s      ddt = u s + state_sum(A q)
        dA += dt q (over t from the last step, then over batch rows)
        dB += g (dt u),  dC += dy h_t  (over channels, ``_chunk_sum``)

    and ``dh0 = a_1 g_1``.  The states ``h_{t-1}`` are rebuilt from the
    ones at every ``SUB_STEPS``-th step by the forward's own operations,
    so they are the forward's bit for bit.
    """
    check_shapes(u, dt, A, Bc, Cc, h0)
    if dy.shape != u.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{tuple(u.shape)}")
    if dh_T is not None and dh_T.shape != h0.shape:
        raise ValueError(f"dh_T has shape {tuple(dh_T.shape)}, expected "
                         f"{tuple(h0.shape)}")
    u, dt, A, Bc, Cc, dy = (t.float() for t in (u, dt, A, Bc, Cc, dy))
    T = u.shape[1]
    carry = torch.zeros_like(h0, dtype=torch.float32) if dh_T is None \
        else dh_T.float()
    starts = chunk_starts(u, dt, A, Bc, h0)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB_terms = torch.empty(u.shape + (A.shape[-1],), dtype=torch.float32,
                           device=u.device) if T else None
    dC_terms = torch.empty_like(dB_terms) if T else None
    acc = torch.zeros_like(carry)     # dA of each batch row
    for k in reversed(range(len(starts))):
        t0 = k * SUB_STEPS
        hs, das = rebuild_states(u, dt, A, Bc, starts[k], t0,
                                 min(t0 + SUB_STEPS, T))
        for i in reversed(range(len(das))):
            t = t0 + i
            dt_t, u_t, dy_t = dt[:, t, :, None], u[:, t], dy[:, t, :, None]
            g = dy_t * Cc[:, t, None, :] + carry
            s = state_sum(g * Bc[:, t, None, :])
            carry = das[i] * g
            q = carry * hs[i]
            acc = acc + dt_t * q
            du[:, t] = dt[:, t] * s
            ddt[:, t] = u_t * s + state_sum(A * q)
            dB_terms[:, t] = g * (dt[:, t] * u_t)[..., None]
            dC_terms[:, t] = dy_t * hs[i + 1]
    dA = acc[0]
    for b in range(1, acc.shape[0]):
        dA = dA + acc[b]
    if T:
        dB = _chunk_sum(dB_terms, BWD_CHANNELS)
        dC = _chunk_sum(dC_terms, BWD_CHANNELS)
    else:
        dB, dC = torch.zeros_like(Bc), torch.zeros_like(Cc)
    return du, ddt, dA, dB, dC, carry
