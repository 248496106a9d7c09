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
"""
from __future__ import annotations

import torch

__all__ = ["check_shapes", "selective_scan_ref", "state_sum"]


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
