"""ctypes wrapper of the CUDA kernel in ``csrc/selective_scan.cu``.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current CUDA stream of the
inputs' device and raises if the launch was refused.  It does not
synchronise.  It adds one to its launch count where it launches, and
nowhere else.  The kernel plans its own grid (channels a block, by the
occupancy API); :func:`plan` reads that plan.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import check_shapes

__all__ = ["selective_scan", "selective_scan_variant", "plan",
           "launch_counts", "reset_launch_counts", "STATE", "CHUNK_STEPS",
           "VARIANTS"]

_launches = {"selective_scan": 0}

STATE = 16             # the state size N the kernel is written for
CHUNK_STEPS = 64       # steps a staged run holds (csrc kSteps)
VARIANTS = (2, 4, 8)   # states a thread the kernel is built for
_MAX_CHANNELS = 128    # channels a block at most (csrc kCols)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN_KEYS = ("k", "channels", "threads", "smem_bytes", "blocks_per_sm",
              "grid", "sms", "steps_per_run")


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
        lib.selective_scan_launch_variant.argtypes = \
            [_P] * 8 + [_I] * 5 + [_P]
        lib.selective_scan_launch_variant.restype = _I
        lib.selective_scan_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
        lib.selective_scan_plan.restype = _I
    return lib


def _check_variant(k: int, channels: int) -> None:
    if k not in (0, *VARIANTS):
        raise ValueError(f"k={k}: the kernel is built for {VARIANTS} states "
                         "a thread (0: the main path's)")
    if channels < 0 or channels % 4 or channels > _MAX_CHANNELS:
        raise ValueError(f"channels={channels}: a multiple of 4 up to "
                         f"{_MAX_CHANNELS} (0: planned)")


def plan(k: int, b: int, di: int, channels: int = 0) -> dict:
    """The launch plan for ``b`` batch rows of ``di`` channels with ``k``
    states a thread (0: the main path's) and ``channels`` channels a
    block (0: planned) on the current device: ``k``, ``channels``,
    ``threads``, ``smem_bytes``, ``blocks_per_sm`` (occupancy API),
    ``grid``, ``sms``, ``steps_per_run``."""
    _check_variant(k, channels)
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _lib().selective_scan_plan(k, b, di, channels, out)
    if err:
        raise RuntimeError(f"selective_scan plan failed with CUDA error "
                           f"{err}")
    return dict(zip(_PLAN_KEYS, out))


def _launch(u, dt, A, Bc, Cc, h0, variant=None):
    """Check, allocate and launch: the main path's entry point, or the
    variant entry point with ``variant = (k, channels)``."""
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
    y = torch.empty((B, T, Di), dtype=torch.float32, device=u.device)
    h_t = torch.empty((B, Di, STATE), dtype=torch.float32, device=u.device)
    if B * Di == 0:
        return y, h_t
    lib = _lib()
    ptrs = (u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), B, T,
            Di)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.selective_scan_launch(*ptrs, stream) if variant is None else \
        lib.selective_scan_launch_variant(*ptrs, *variant, stream)
    if err:
        raise RuntimeError(f"selective_scan launch failed with CUDA error "
                           f"{err}")
    _launches["selective_scan"] += 1
    return y, h_t


def selective_scan(u, dt, A, Bc, Cc, h0):
    """CUDA selective scan: float32 u, dt [B,T,Di], A [Di,16], Bc, Cc
    [B,T,16], h0 [B,Di,16] -> (y [B,T,Di], h_T [B,Di,16]), float32 (see
    ``ref.selective_scan_ref``)."""
    return _launch(u, dt, A, Bc, Cc, h0)


def selective_scan_variant(u, dt, A, Bc, Cc, h0, k: int, channels: int = 0):
    """:func:`selective_scan` with ``k`` states a thread (2, 4 or 8) and
    ``channels`` channels a block (a multiple of 4 up to 128; 0: planned):
    the variants the bench holds to the plain version and times."""
    _check_variant(k, channels)
    return _launch(u, dt, A, Bc, Cc, h0, (k, channels))
