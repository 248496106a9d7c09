"""ctypes wrappers of the CUDA kernels in ``csrc/switch_arb.cu``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream of the
inputs' device and raises if the launch was refused.  It does not
synchronise.  Each adds one to its launch count where it launches, and
nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["vc_prearb", "switch_arbitrate", "switch_arbitrate_rows",
           "rows_geometry", "launch_counts", "reset_launch_counts",
           "MAX_SHARED_BYTES", "MAX_ROWS", "MAX_GRID_Y", "ROWS_LANES",
           "ROWS_MAIN_LANES"]

# static shared memory limit a block may ask for without an opt-in
MAX_SHARED_BYTES = 48 * 1024
# the most dynamic shared memory a block may take on Hopper
MAX_DYNAMIC_SHARED_BYTES = 232_448
# a priority word's low 23 bits hold the flat row index
MAX_ROWS = 1 << 23
# switch_arbitrate_rows' argmin mappings: lanes a row (1: a thread a
# row, 32: a warp a row), and the engine's
ROWS_LANES = (1, 2, 4, 8, 32)
ROWS_MAIN_LANES = 4
# the most replicas a launch takes: the grid's y extent
MAX_GRID_Y = 65535

_launches = {"vc_prearb": 0, "switch_arbitrate": 0,
             "switch_arbitrate_rows": 0}


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
        lib.vc_prearb_launch.argtypes = [_P] * 7 + [_I, _I, _I, _P]
        lib.vc_prearb_launch.restype = _I
        lib.switch_arbitrate_launch.argtypes = [_P] * 10 + [_I, _I, _I, _F,
                                                            _P]
        lib.switch_arbitrate_launch.restype = _I
        lib.switch_arbitrate_rows_smem.argtypes = [_I, _I, _I]
        lib.switch_arbitrate_rows_smem.restype = _I
        lib.switch_arbitrate_rows_launch.argtypes = (
            [_P] * 13 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P])
        lib.switch_arbitrate_rows_launch.restype = _I
        lib.empty_launch.argtypes = [_I, _I, _P]
        lib.empty_launch.restype = _I
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


def vc_prearb(qlen: torch.Tensor, rand: torch.Tensor, buf=None, head=None):
    """CUDA ``vc_prearb``: int32 [N, P, V] + float32 [N, P, V] ->
    int32 ``(sel, has)`` [N, P], and with int32 ``buf`` [N*P*V, depth] and
    ``head`` [N*P*V] also the chosen queue's head packet ``pkt`` [N, P]
    (see ``ref.vc_prearb_ref``).

    Replicas need no axis of their own: the result of a row holds no row
    index, and the gather reads ``buf[(row*V + sel)*depth + head]``, so R
    contiguous replicas of ``[N, P, V]`` inputs and ``[N*P*V, depth]``
    buffers go through as ``R*N`` switches, each replica's rows bitwise
    its own call's."""
    if qlen.device.type != "cuda":
        raise ValueError(f"vc_prearb kernel needs CUDA tensors, got "
                         f"{qlen.device}")
    if qlen.dim() != 3 or qlen.shape[2] < 1:
        raise ValueError(f"qlen must be [N, P, V>=1], got {tuple(qlen.shape)}")
    n, p, v = qlen.shape
    dev = qlen.device
    _check("qlen", qlen, torch.int32, (n, p, v), dev)
    _check("rand", rand, torch.float32, (n, p, v), dev)
    if (buf is None) != (head is None):
        raise ValueError("buf and head come together")
    depth = 0
    if buf is not None:
        if buf.dim() != 2 or buf.shape[1] < 1:
            raise ValueError(f"buf must be [N*P*V, depth>=1], got "
                             f"{tuple(buf.shape)}")
        depth = buf.shape[1]
        _check("buf", buf, torch.int32, (n * p * v, depth), dev)
        _check("head", head, torch.int32, (n * p * v,), dev)
    sel = torch.empty((n, p), dtype=torch.int32, device=dev)
    has = torch.empty((n, p), dtype=torch.int32, device=dev)
    pkt = None if buf is None else torch.empty((n, p), dtype=torch.int32,
                                               device=dev)
    out = (sel, has) if pkt is None else (sel, has, pkt)
    if n * p == 0:
        return out
    err = _lib().vc_prearb_launch(
        qlen.data_ptr(), rand.data_ptr(), sel.data_ptr(), has.data_ptr(),
        None if buf is None else buf.data_ptr(),
        None if head is None else head.data_ptr(),
        None if pkt is None else pkt.data_ptr(), n * p, v, depth,
        _stream(dev))
    if err:
        raise RuntimeError(f"vc_prearb launch failed with CUDA error {err}")
    _launches["vc_prearb"] += 1
    return out


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


def rows_geometry(tie, allowed, deroute, route, rnd, next_vc, oq_len, qlen,
                  nic_first, dq_base, d: int):
    """Check the inputs of ``switch_arbitrate_rows`` (either device) and
    return ``(N, P, V, NR)``.  Inputs may carry a leading replica axis
    ``[R, ...]`` (``tie`` [R, NR, P]; every input but ``nic_first`` and
    ``dq_base`` has it then).  Raises on NR >= 2**23 (the row index must
    fit a priority word's 23 low bits), a wrong dtype or shape, mixed
    devices or a non-contiguous tensor."""
    if tie.dim() not in (2, 3) or tie.shape[-1] < 1:
        raise ValueError(f"tie must be [NR, P>=1] or [R, NR, P>=1], got "
                         f"{tuple(tie.shape)}")
    reps = None if tie.dim() == 2 else tie.shape[0]
    lead = () if reps is None else (reps,)
    if reps is not None and reps < 1:
        raise ValueError(f"tie has {reps} replicas")
    nr, p = tie.shape[-2:]
    if nr >= MAX_ROWS:
        raise ValueError(f"{nr} requester rows: the priority word holds a "
                         f"row index below 2**23 = {MAX_ROWS}")
    if nic_first.dim() != 1:
        raise ValueError(f"nic_first must be [N], got "
                         f"{tuple(nic_first.shape)}")
    n = nic_first.shape[0]
    per = oq_len.numel() // max(reps or 1, 1)
    if n == 0 or per % (n * p):
        raise ValueError(f"oq_len has {oq_len.numel()} elements, not "
                         f"{reps or 1} times a multiple of N*P = {n * p}")
    v = per // (n * p)
    if v < 1 or d < 1 or nr < n * p:
        raise ValueError(f"V={v}, d={d}, NR={nr} < N*P={n * p}")
    dev = tie.device
    _check("tie", tie, torch.float32, lead + (nr, p), dev)
    _check("allowed", allowed, torch.bool, lead + (nr, p), dev)
    _check("deroute", deroute, torch.bool, lead + (nr, p), dev)
    _check("route", route, torch.bool, lead + (nr,), dev)
    _check("rnd", rnd, torch.int32, lead + (nr,), dev)
    _check("next_vc", next_vc, torch.int32, lead + (nr,), dev)
    _check("oq_len", oq_len, torch.int32, lead + (n * p * v,), dev)
    _check("qlen", qlen, torch.int32, lead + (n * p * v,), dev)
    _check("nic_first", nic_first, torch.int32, (n,), dev)
    _check("dq_base", dq_base, torch.int32, (n * p,), dev)
    return n, p, v, nr


def switch_arbitrate_rows(tie, allowed, deroute, route, rnd, next_vc,
                          oq_len, qlen, *, nic_first, dq_base, d: int,
                          penalty: float, out_queue: int,
                          zero_occ: bool = False,
                          lanes: Optional[int] = None):
    """CUDA ``switch_arbitrate_rows`` on the engine's flat requester rows;
    returns int32 ``(port [NR], win [NR], seg [N*P])`` (see
    ``ref.switch_arbitrate_rows_ref``).  ``lanes`` a row in the argmin
    (one of ``ROWS_LANES``; default ``ROWS_MAIN_LANES``).

    Inputs with a leading replica axis ``[R, ...]`` (the geometry
    shared) give outputs ``[R, ...]`` from one launch, a block per
    (switch, replica); at R = 1 that launch is the unbatched one."""
    if tie.device.type != "cuda":
        raise ValueError(f"switch_arbitrate_rows kernel needs CUDA tensors, "
                         f"got {tie.device}")
    n, p, v, nr = rows_geometry(tie, allowed, deroute, route, rnd, next_vc,
                                oq_len, qlen, nic_first, dq_base, d)
    reps = tie.shape[0] if tie.dim() == 3 else None
    lanes = lanes or ROWS_MAIN_LANES
    if lanes not in ROWS_LANES:
        raise ValueError(f"lanes {lanes} is not one of {ROWS_LANES}")
    lib = _lib()
    shared = lib.switch_arbitrate_rows_smem(p, v, d)
    if shared > MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(f"P={p}, V={v}, d={d} need {shared} bytes of "
                         f"shared memory per block, more than "
                         f"{MAX_DYNAMIC_SHARED_BYTES}")
    if reps is not None and reps > MAX_GRID_Y:
        raise ValueError(f"{reps} replicas: a launch takes at most "
                         f"{MAX_GRID_Y}")
    dev = tie.device
    lead = () if reps is None else (reps,)
    port = torch.empty(lead + (nr,), dtype=torch.int32, device=dev)
    win = torch.empty(lead + (nr,), dtype=torch.int32, device=dev)
    seg = torch.empty(lead + (n * p,), dtype=torch.int32, device=dev)
    err = lib.switch_arbitrate_rows_launch(
        tie.data_ptr(), allowed.data_ptr(), deroute.data_ptr(),
        route.data_ptr(), rnd.data_ptr(), next_vc.data_ptr(),
        oq_len.data_ptr(), qlen.data_ptr(), nic_first.data_ptr(),
        dq_base.data_ptr(), port.data_ptr(), win.data_ptr(), seg.data_ptr(),
        n, p, v, d, float(penalty), int(out_queue), int(bool(zero_occ)),
        lanes, reps or 1, nr, _stream(dev))
    if err:
        raise RuntimeError(f"switch_arbitrate_rows launch failed with CUDA "
                           f"error {err}")
    _launches["switch_arbitrate_rows"] += 1
    return port, win, seg
