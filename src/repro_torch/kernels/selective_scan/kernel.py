"""ctypes wrappers of the CUDA kernels in ``csrc/selective_scan.cu`` (the
scan) and ``csrc/selective_scan_bwd.cu`` (its gradient).

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs (and the backward's scratch) with ``torch.empty``, launches on
the current CUDA stream of the inputs' device and raises if the launch
was refused.  It does not synchronise.  It adds one to its kernel's
launch count where it launches, and nowhere else.  The forward kernel
plans its own grid (channels a block, by the occupancy API); :func:`plan`
reads that plan.  The backward's grid is fixed: ``BWD_CHANNELS``
channels a block, one block per (batch row, channel run);
:func:`bwd_plan` reads its launch plan.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import BWD_CHANNELS, CHUNK_STEPS, SUB_STEPS, check_shapes

__all__ = ["selective_scan", "selective_scan_variant", "selective_scan_bwd",
           "plan", "bwd_plan", "launch_counts", "reset_launch_counts",
           "STATE", "CHUNK_STEPS", "VARIANTS", "BWD_CHANNELS"]

_launches = {"selective_scan": 0, "selective_scan_bwd": 0}

STATE = 16             # the state size N the kernels are written for
# CHUNK_STEPS: steps a staged run of either kernel holds (csrc kSteps,
# kRun); SUB_STEPS: steps between the states the backward keeps (kSub)
VARIANTS = (2, 4, 8)   # states a thread the kernel is built for
_MAX_CHANNELS = 128    # channels a block at most (csrc kCols)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN_KEYS = ("k", "channels", "threads", "smem_bytes", "blocks_per_sm",
              "grid", "sms", "steps_per_run")
_BWD_PLAN_KEYS = ("channels", "threads", "smem_bytes", "blocks_per_sm",
                  "grid", "sms", "registers", "local_bytes")


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


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("selective_scan_bwd")
    if lib.selective_scan_bwd_launch.argtypes is None:
        lib.selective_scan_bwd_launch.argtypes = [_P] * 18 + [_I] * 3 + [_P]
        lib.selective_scan_bwd_launch.restype = _I
        lib.selective_scan_bwd_plan.argtypes = [_I] * 2 + [
            ctypes.POINTER(_I)]
        lib.selective_scan_bwd_plan.restype = _I
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


def bwd_plan(b: int, di: int) -> dict:
    """The backward's launch plan for ``b`` batch rows of ``di`` channels
    on the current device: ``channels``, ``threads``, ``smem_bytes``,
    ``blocks_per_sm`` (occupancy API), ``grid``, ``sms``, ``registers``
    and ``local_bytes`` (a thread's, from the built kernel)."""
    out = (ctypes.c_int * len(_BWD_PLAN_KEYS))()
    err = _lib_bwd().selective_scan_bwd_plan(b, di, out)
    if err:
        raise RuntimeError(f"selective_scan_bwd plan failed with CUDA error "
                           f"{err}")
    return dict(zip(_BWD_PLAN_KEYS, out))


def _check(name: str, args) -> None:
    """The checks of every launch: CUDA, one device, float32, contiguous,
    the scan's shapes, N = 16.  ``args``: ``(name, tensor)`` pairs, the
    scan's six inputs first."""
    u = args[0][1]
    if u.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{u.device}")
    for label, t in args:
        if t.device != u.device:
            raise ValueError(f"{label} is on {t.device}, expected "
                             f"{u.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{label} has dtype {t.dtype}, expected "
                            "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{label} is not contiguous")
    check_shapes(*(t for _, t in args[:6]))
    if args[2][1].shape[1] != STATE:
        raise ValueError(f"state size {args[2][1].shape[1]}: the kernel "
                         f"takes N = {STATE}")


def _launch(u, dt, A, Bc, Cc, h0, variant=None):
    """Check, allocate and launch: the main path's entry point, or the
    variant entry point with ``variant = (k, channels)``."""
    _check("selective_scan", (("u", u), ("dt", dt), ("A", A), ("Bc", Bc),
                              ("Cc", Cc), ("h0", h0)))
    B, T, Di = u.shape
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


def selective_scan_bwd(u, dt, A, Bc, Cc, h0, dy, dh_T=None):
    """CUDA backward of :func:`selective_scan`: float32 inputs as there,
    ``dy`` [B,T,Di] and ``dh_T`` [B,Di,16] (None: zeros) -> ``(du, ddt,
    dA, dB, dC, dh0)``, float32, equal to ``ref.selective_scan_bwd_ref``
    bit for bit.  Two launches on the current stream (the scan backward,
    then the sums over channel blocks and batch rows), counted as one.
    Scratch: the states every ``SUB_STEPS`` steps ``[B, ceil(T/8), Di,
    16]`` (210 MB at Hymba's training shape ``[2, 4096, 3200]``), the
    per-block sums of dB and dC (two ``[B, T, ceil(Di/64), 16]``) and
    dA's rows ``[B, Di, 16]``, float32.  Bound: two MUFU ``ex2`` a (b, t,
    channel, state), 0.2006 ms at Hymba's shape
    (``bench.scan_bwd_bound_ms``); the design is in the header of
    ``csrc/selective_scan_bwd.cu``."""
    args = [("u", u), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc),
            ("h0", h0), ("dy", dy)]
    if dh_T is not None:
        args.append(("dh_T", dh_T))
    _check("selective_scan_bwd", args)
    if dy.shape != u.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected "
                         f"{tuple(u.shape)}")
    if dh_T is not None and dh_T.shape != h0.shape:
        raise ValueError(f"dh_T has shape {tuple(dh_T.shape)}, expected "
                         f"{tuple(h0.shape)}")
    B, T, Di = u.shape
    dev = u.device
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    if B * Di == 0 or T == 0:
        dh0 = torch.zeros_like(h0) if dh_T is None else dh_T.clone()
        return du, ddt, torch.zeros_like(A), dB.zero_(), dC.zero_(), dh0
    dA = torch.empty_like(A)
    dh0 = torch.empty_like(h0)
    nblk = -(-Di // BWD_CHANNELS)
    ws = torch.empty((B, -(-T // SUB_STEPS), Di, STATE),
                     dtype=torch.float32, device=dev)
    pdb = torch.empty((B, T, nblk, STATE), dtype=torch.float32, device=dev)
    pdc = torch.empty_like(pdb)
    pda = torch.empty_like(h0)
    lib = _lib_bwd()
    ptrs = [t.data_ptr() for t in (u, dt, A, Bc, Cc, h0, dy)]
    ptrs.append(None if dh_T is None else dh_T.data_ptr())
    ptrs += [t.data_ptr() for t in (du, ddt, dA, dB, dC, dh0, ws, pdb, pdc,
                                    pda)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.selective_scan_bwd_launch(*ptrs, B, T, Di, stream)
    if err:
        raise RuntimeError(f"selective_scan_bwd launch failed with CUDA "
                           f"error {err}")
    _launches["selective_scan_bwd"] += 1
    return du, ddt, dA, dB, dC, dh0
