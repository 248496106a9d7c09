"""ctypes wrapper of the CUDA kernel in ``csrc/selective_scan.cu``.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current CUDA stream of the
inputs' device and raises if the launch was refused.  It does not
synchronise.  It adds one to its launch count where it launches, and
nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import check_shapes

__all__ = ["selective_scan", "launch_counts", "reset_launch_counts",
           "STATE"]

_launches = {"selective_scan": 0}

STATE = 16             # the state size N the kernel is written for
_CHANNELS_PER_BLOCK = 16
_MAX_GRID_Y = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("selective_scan")
    if lib.selective_scan_launch.argtypes is None:
        lib.selective_scan_launch.argtypes = [_P] * 8 + [_I, _I, _I, _P]
        lib.selective_scan_launch.restype = _I
    return lib


def selective_scan(u, dt, A, Bc, Cc, h0):
    """CUDA selective scan: float32 u, dt [B,T,Di], A [Di,16], Bc, Cc
    [B,T,16], h0 [B,Di,16] -> (y [B,T,Di], h_T [B,Di,16]), float32 (see
    ``ref.selective_scan_ref``)."""
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan kernel needs CUDA tensors, got "
                         f"{u.device}")
    args = (("u", u), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc),
            ("h0", h0))
    for name, t in args:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, expected {u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    check_shapes(u, dt, A, Bc, Cc, h0)
    B, T, Di = u.shape
    if A.shape[1] != STATE:
        raise ValueError(f"state size {A.shape[1]}: the kernel takes "
                         f"N = {STATE}")
    if B > _MAX_GRID_Y:
        raise ValueError(f"B={B} exceeds the kernel's grid")
    y = torch.empty((B, T, Di), dtype=torch.float32, device=u.device)
    h_t = torch.empty((B, Di, STATE), dtype=torch.float32, device=u.device)
    if B * Di == 0:
        return y, h_t
    err = _lib().selective_scan_launch(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), B, T, Di,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan launch failed with CUDA error "
                           f"{err}")
    _launches["selective_scan"] += 1
    return y, h_t
