"""ctypes wrapper of the CUDA kernel in ``csrc/minplus.cu``.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current CUDA stream of the
inputs' device and raises if the launch was refused.  It does not
synchronise.  It adds one to its launch count where it launches, and
nowhere else, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["minplus", "launch_counts", "reset_launch_counts"]

_launches = {"minplus": 0}

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
