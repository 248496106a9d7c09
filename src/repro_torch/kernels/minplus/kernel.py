"""ctypes wrappers of the CUDA kernels in ``csrc/minplus.cu``: the float32
product (``minplus``) and the int16 hop-count product on Hopper's DPX
instructions (``minplus_hops``).

Each wrapper checks device, dtype, shape and layout, allocates the output
with ``torch.empty`` (or writes the caller's ``out``), launches on the
current CUDA stream of the inputs' device and raises if the launch was
refused.  It does not synchronise.  Each adds one to its launch count
where it launches, and nowhere else, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["minplus", "minplus_hops", "launch_counts",
           "reset_launch_counts"]

_launches = {"minplus": 0, "minplus_hops": 0}

# rows of C per block (BM in csrc/minplus.cu) and the grid's y-limit
_BM, _MAX_GRID_Y = 64, 65535


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("minplus")
    if lib.minplus_launch.argtypes is None:
        lib.minplus_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.minplus_launch.restype = _I
        lib.minplus_hops_launch.argtypes = [_P, _P, _P] + [_I] * 6 + [_P]
        lib.minplus_hops_launch.restype = _I
        # the DPX issue-rate probe (csrc/dpx_probe.cuh; run by bench.py)
        lib.dpx_probe_launch.argtypes = [_I, _P, _P, _P, _I, _I, _P]
        lib.dpx_probe_launch.restype = _I
        lib.dpx_probe_occupancy.argtypes = [_I]
        lib.dpx_probe_occupancy.restype = _I
    return lib


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CUDA ``minplus``: float32 ``a`` [M, K] (min, +) ``b`` [K, N] ->
    float32 [M, N], capped at ``INF`` (see ``ref.minplus_ref``)."""
    if a.device.type != "cuda":
        raise ValueError(f"minplus kernel needs CUDA tensors, got {a.device}")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "torch.float32")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if -(-m // _BM) > _MAX_GRID_Y:
        raise ValueError(f"M={m} rows exceed the kernel's grid")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m * n == 0:
        return c
    err = _lib().minplus_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                m, n, k,
                                torch.cuda.current_stream(a.device)
                                .cuda_stream)
    if err:
        raise RuntimeError(f"minplus launch failed with CUDA error {err}")
    _launches["minplus"] += 1
    return c


def _check_hops(name: str, t: torch.Tensor) -> None:
    """The int16 row layout of ``minplus_hops``: 2-D, rows contiguous, a
    leading dimension of a multiple of 8 entries, 16-byte aligned, and
    every row readable up to its next multiple of 8 entries (the kernel
    copies 16-byte chunks)."""
    if t.dtype != torch.int16:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int16")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    rows, cols = t.shape
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}'s rows are not contiguous "
                         f"(strides {t.stride()})")
    ld = t.stride(0)
    if ld % 8 or ld < cols:
        raise ValueError(f"{name}'s leading dimension {ld} is not a "
                         "multiple of 8 entries at least as wide as a row "
                         "(see ref.padded_hops)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    if rows and cols:
        end = t.storage_offset() + (rows - 1) * ld + -(-cols // 8) * 8
        if 2 * end > t.untyped_storage().nbytes():
            raise ValueError(f"{name}'s last row, padded to a multiple of "
                             "8 entries, runs past its storage")


def minplus_hops(at: torch.Tensor, b: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA ``minplus_hops``: int16 ``at`` [K, M] (A given k-major)
    (min, +) ``b`` [K, N] -> int16 [M, N], capped at ``HOPS_INF`` (see
    ``ref.minplus_hops_ref``).  Operands and ``out`` take the layout of
    ``ref.padded_hops``; without ``out`` the result is such a view."""
    for name, t in (("at", at), ("b", b)):
        _check_hops(name, t)
    (k, m), (k2, n) = at.shape, b.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: {tuple(at.shape)}^T x "
                         f"{tuple(b.shape)}")
    if at.device.type != "cuda":
        raise ValueError(f"minplus_hops kernel needs CUDA tensors, got "
                         f"{at.device}")
    if out is None:
        ld = max(8, -(-n // 8) * 8)
        out = torch.empty((m, ld), dtype=torch.int16,
                          device=at.device)[:, :n]
    _check_hops("out", out)
    if tuple(out.shape) != (m, n):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(m, n)}")
    for name, t in (("b", b), ("out", out)):
        if t.device != at.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{at.device}")
    if m * n == 0:
        return out
    err = _lib().minplus_hops_launch(
        at.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, at.stride(0),
        b.stride(0), out.stride(0),
        torch.cuda.current_stream(at.device).cuda_stream)
    if err:
        raise RuntimeError(f"minplus_hops launch failed with CUDA error "
                           f"{err}")
    _launches["minplus_hops"] += 1
    return out
