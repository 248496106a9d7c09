"""ctypes wrappers of the CUDA kernels in ``csrc/switch_arb.cu``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream of the
inputs' device and raises if the launch was refused.  It does not
synchronise.  Each adds one to its launch count where it launches, and
nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["vc_prearb", "switch_arbitrate", "launch_counts",
           "reset_launch_counts", "MAX_SHARED_BYTES"]

# static shared memory limit a block may ask for without an opt-in
MAX_SHARED_BYTES = 48 * 1024

_launches = {"vc_prearb": 0, "switch_arbitrate": 0}


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("switch_arb")
    if lib.vc_prearb_launch.argtypes is None:
        lib.vc_prearb_launch.argtypes = [_P, _P, _P, _P, _I, _I, _P]
        lib.vc_prearb_launch.restype = _I
        lib.switch_arbitrate_launch.argtypes = [_P] * 10 + [_I, _I, _I, _F,
                                                            _P]
        lib.switch_arbitrate_launch.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vc_prearb(qlen: torch.Tensor, rand: torch.Tensor):
    """CUDA ``vc_prearb``: int32 [N, P, V] + float32 [N, P, V] ->
    int32 ``(sel, has)`` [N, P] (see ``ref.vc_prearb_ref``)."""
    if qlen.device.type != "cuda":
        raise ValueError(f"vc_prearb kernel needs CUDA tensors, got "
                         f"{qlen.device}")
    if qlen.dim() != 3 or qlen.shape[2] < 1:
        raise ValueError(f"qlen must be [N, P, V>=1], got {tuple(qlen.shape)}")
    n, p, v = qlen.shape
    _check("qlen", qlen, torch.int32, (n, p, v), qlen.device)
    _check("rand", rand, torch.float32, (n, p, v), qlen.device)
    sel = torch.empty((n, p), dtype=torch.int32, device=qlen.device)
    has = torch.empty((n, p), dtype=torch.int32, device=qlen.device)
    if n * p == 0:
        return sel, has
    err = _lib().vc_prearb_launch(qlen.data_ptr(), rand.data_ptr(),
                                  sel.data_ptr(), has.data_ptr(), n * p, v,
                                  _stream(qlen.device))
    if err:
        raise RuntimeError(f"vc_prearb launch failed with CUDA error {err}")
    _launches["vc_prearb"] += 1
    return sel, has


def switch_arbitrate(occ, deroute, mask, tie, route, rnd, lo, *,
                     penalty: float):
    """CUDA ``switch_arbitrate`` on the dense [N, R, P] layout; returns
    int32 ``(port [N, R], win [N, R], seg [N, P])`` (see
    ``ref.switch_arbitrate_ref``)."""
    if occ.device.type != "cuda":
        raise ValueError(f"switch_arbitrate kernel needs CUDA tensors, got "
                         f"{occ.device}")
    if occ.dim() != 3:
        raise ValueError(f"occ must be [N, R, P], got {tuple(occ.shape)}")
    n, r, p = occ.shape
    dev = occ.device
    for name, t in (("occ", occ), ("deroute", deroute), ("mask", mask)):
        _check(name, t, torch.int32, (n, r, p), dev)
    _check("tie", tie, torch.float32, (n, r, p), dev)
    for name, t in (("route", route), ("rnd", rnd), ("lo", lo)):
        _check(name, t, torch.int32, (n, r), dev)
    shared = (p + 2 * r) * 4
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"R={r}, P={p} need {shared} bytes of shared "
                         f"memory per block, more than {MAX_SHARED_BYTES}")
    port = torch.empty((n, r), dtype=torch.int32, device=dev)
    win = torch.empty((n, r), dtype=torch.int32, device=dev)
    seg = torch.empty((n, p), dtype=torch.int32, device=dev)
    if n == 0 or p == 0:
        return port, win, seg
    err = _lib().switch_arbitrate_launch(
        occ.data_ptr(), deroute.data_ptr(), mask.data_ptr(), tie.data_ptr(),
        route.data_ptr(), rnd.data_ptr(), lo.data_ptr(), port.data_ptr(),
        win.data_ptr(), seg.data_ptr(), n, r, p, float(penalty),
        _stream(dev))
    if err:
        raise RuntimeError(f"switch_arbitrate launch failed with CUDA "
                           f"error {err}")
    _launches["switch_arbitrate"] += 1
    return port, win, seg
