"""The open-loop arrival source's float32 arithmetic, as the reference
computes it.

The reference (``repro.simulator.engine``, ``Traffic("arrival")``) runs
its step as one XLA program on the CPU, and two of the source's float32
expressions do not come out of PyTorch's own operations bit for bit:

* XLA contracts ``c + a * b`` inside a fused loop into one fused
  multiply-add (one rounding): the pareto base ``1 - u * (1 - cap^-a)``
  and the diurnal factor ``1 + amp * sin(.)``.  :func:`fma_f32` computes
  it exactly, in float64 with a round-to-odd sum.
* XLA's CPU ``sin`` calls the C library's ``sinf`` (glibc's, from ARM's
  optimized routines: the argument is reduced and the polynomial
  evaluated in float64, the reduction ``x - n * pi/2`` by a fused
  multiply-add).  :func:`sinf` is that routine in float64 and int64
  tensor operations, for arguments >= 0.

Both run elementwise on the device of their inputs, without a host
synchronisation.  The pareto batch size is a step function of the
uniform draw, which takes one of 2^23 values: :func:`pareto_thresholds`
evaluates the reference's expression over all of them on the host once
per ``(alpha, cap)`` and keeps the draw at which each batch size
starts, so the step's map (:func:`pareto_batch`) is a bucket search
and does not depend on the device's ``pow``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["fma_f32", "sinf", "diurnal_rate", "pareto_thresholds",
           "pareto_batch", "UNIFORM_STEPS"]

# jax's float32 uniform in [0, 1) is m * 2^-23 for a 23-bit integer m
UNIFORM_STEPS = 1 << 23


def _f32(x: float) -> float:
    return float(np.float32(x))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float32 ``a``; ``b`` and
    ``c`` float32 tensors or Python floats exact in float32).

    The product is exact in float64; the sum is rounded to odd there
    (TwoSum's error term, and one step away from an even result when it
    is not zero), so the final rounding to float32 is the one a fused
    multiply-add makes."""
    p = a.double() * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


# glibc's sinf (sysdeps/ieee754/flt-32/s_sinf.c, sincosf.h and
# s_sincosf_data.c): 4/pi to 192 bits, pi/2 and its inverse (scaled by
# 2^24), 2pi * 2^-64, and the polynomials of the first table entry
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
# pi/2 split so that n * _HPI_HI is exact for the fast path's n < 2^7
_HPI_HI = float.fromhex("0x1.921fb5p0")
_HPI_LO = _HPI - _HPI_HI
_PI63 = float.fromhex("0x1.921FB54442D18p-62")
_C0, _C1, _C2, _C3, _C4 = (float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S1, _S2, _S3 = (float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
# the top 12 bits (sign cleared) of 2^-12, pi/4 and 120 as float32
_TOP_TINY, _TOP_PIO4, _TOP_120 = 0x398, 0x3f4, 0x42f


@functools.lru_cache(maxsize=None)
def _inv_pio4(device: torch.device) -> torch.Tensor:
    return torch.tensor(_INV_PIO4, dtype=torch.int64, device=device)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf`` of a float32 tensor ``y`` of finite values >= 0,
    bit for bit.  Below 2^-12 it returns ``y``; below pi/4 the sine
    polynomial; below 120 a reduction by one multiply-subtract; above, a
    96-bit fixed-point product with 4/pi.  Every branch is computed and
    the result selected elementwise."""
    yi = y.view(torch.int32).to(torch.int64)
    top = (yi >> 20) & 0x7ff
    small, fast = top < _TOP_PIO4, top < _TOP_120
    x = y.to(torch.float64)
    # fast reduction: n = round(x * 2/pi) by a scaled conversion, then
    # x - n * pi/2 with one rounding (exact products, Sterbenz subtract)
    r = torch.where(fast, x, 0.0) * _HPI_INV
    n_fast = ((r.to(torch.int32) + 0x800000) >> 24).to(torch.int64)
    nf = n_fast.to(torch.float64)
    x_fast = (x - nf * _HPI_HI) - nf * _HPI_LO
    # large reduction: 24-bit mantissa times 96 bits of 4/pi, modulo 2^64
    # (int64 arithmetic wraps as glibc's uint64 does)
    tab = _inv_pio4(y.device)
    idx = (yi >> 26) & 15
    m = ((yi & 0xffffff) | 0x800000) << ((yi >> 23) & 7)
    res0 = (m * tab[idx]) & 0xffffffff
    res0 = ((m * tab[idx + 8]) >> 32) | (res0 << 32)
    res0 = res0 + m * tab[idx + 4]
    n_large = ((res0 + (1 << 61)) >> 62) & 3
    x_large = (res0 - (n_large << 62)).to(torch.float64) * _PI63
    n = torch.where(small, 0, torch.where(fast, n_fast, n_large))
    xr = torch.where(small, x, torch.where(fast, x_fast, x_large))
    q = n & 3
    # quadrants 1 and 2 negate the argument of the sine polynomial and
    # 2 and 3 the cosine polynomial (the second table entry)
    xs = torch.where((q == 1) | (q == 2), -xr, xr)
    x2 = xr * xr
    x3 = xs * x2
    sin_p = (xs + x3 * _S1) + (x3 * x2) * (_S2 + x2 * _S3)
    x4 = x2 * x2
    cos_p = ((_C0 + x2 * _C1) + x4 * _C2) + (x4 * x2) * (_C3 + x2 * _C4)
    cos_p = torch.where(q >= 2, -cos_p, cos_p)
    out = torch.where((n & 1) == 1, cos_p, sin_p).to(torch.float32)
    return torch.where(top < _TOP_TINY, y, out)


def diurnal_rate(slot: torch.Tensor, load: float, amp: float,
                 period: int) -> torch.Tensor:
    """The diurnal source's float32 arrival probability at each slot of
    ``slot`` (int32): ``load * (1 + amp * sin(w * slot))`` with ``w =
    2 pi / period``, rounded as the reference's XLA program rounds it."""
    w = _f32(2.0 * math.pi / period)
    s = sinf(slot.to(torch.float32) * w)
    return _f32(load) * fma_f32(s, _f32(amp), 1.0)


@functools.lru_cache(maxsize=None)
def _thresholds(alpha: float, cap: int) -> np.ndarray:
    m = torch.arange(UNIFORM_STEPS, dtype=torch.int32)
    u = m.to(torch.float32) * 2.0 ** -23
    base = fma_f32(-u, _f32(1.0 - float(cap) ** -alpha), 1.0)
    x = base.pow(_f32(-1.0 / alpha))
    batch = x.floor().clamp(1, cap).to(torch.int32)
    if not bool((batch[1:] >= batch[:-1]).all()):
        raise RuntimeError(f"pareto batch sizes (alpha {alpha}, cap {cap}) "
                           "are not monotone in the uniform draw")
    first = torch.searchsorted(batch, torch.arange(2, cap + 1,
                                                   dtype=torch.int32))
    return first.to(torch.int32).numpy()


def pareto_thresholds(alpha: float, cap: int,
                      device=None) -> torch.Tensor:
    """int32 ``[cap - 1]``: for k = 2 .. cap, the least ``m`` whose draw
    ``u = m * 2^-23`` gives a batch of at least k packets under the
    reference's ``clip(floor((1 - u (1 - cap^-alpha))^(-1/alpha)), 1,
    cap)``, with its base rounded once (XLA's fused multiply-add) and
    float32 ``pow``.  Computed on the host, once per ``(alpha, cap)``."""
    return torch.as_tensor(_thresholds(float(alpha), int(cap)),
                           device=device)


def pareto_batch(u: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """int32 batch sizes of the float32 uniform draws ``u``: one plus the
    number of thresholds at or below each draw's integer ``m``."""
    m = (u * float(UNIFORM_STEPS)).to(torch.int32)
    return torch.bucketize(m, thresholds, out_int32=True, right=True) + 1
