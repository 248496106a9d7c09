"""ctypes wrapper of the CUDA kernel in ``csrc/flash_attention.cu``.

The wrapper checks device, dtype, shape, alignment and contiguity (the
kernel reads q, k and v with TMA, which takes 16-byte aligned rows and
strides), allocates the output with ``torch.empty``, launches on the
current CUDA stream of the inputs' device and raises if the launch was
refused.  It does not synchronise.  It adds one to its launch count
where it launches, and nowhere else.

``key_tiles`` mirrors, in plain Python, the key tiles each block of the
kernel visits and the order of its grid, so that the CPU tests can hold
the schedule to the mask.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .ref import BLOCK_K, check_shapes

__all__ = ["flash_attention", "launch_counts", "reset_launch_counts",
           "key_tiles", "HEAD_DIMS", "NONCAUSAL_HEAD_DIMS", "BLOCK_Q"]

_launches = {"flash_attention": 0}

# the kernel's instantiations, (query and key dim, value dim): reduced
# Hymba, Hymba, the dense and MoE models, DeepSeek-V3's MLA
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 128))
# the non-causal instantiations: seamless-m4t-medium's encoder and cross
# layers, llama-3.2-vision-90b's cross layers
NONCAUSAL_HEAD_DIMS = ((64, 64), (128, 128))
BLOCK_Q = 64             # queries per block (the kernel's kBQ)
_MAX_GRID_YZ = 65535
_MAP_ERROR = 100000      # the kernel's kMapError: a tensor map was refused

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def key_tiles(sq: int, skv: int, window: Optional[int] = None,
              causal: bool = True) -> list:
    """``[(query tile, first key tile, last key tile)]`` in the order of
    the kernel's grid (``blockIdx.x``), for one (batch, head): the blocks
    take the query tiles from the last (causal: the heaviest) to the
    first.  Causal, each walks the key tiles (of ``ref.BLOCK_K``) between
    the first that holds a key its first query sees and the last that
    holds a key its last query sees (``flash_attention_kernel``'s
    ``t_lo`` and ``n_tiles``); not causal, every key tile."""
    n_qt = -(-sq // BLOCK_Q)
    off = skv - sq
    out = []
    for x in range(n_qt):
        qt = n_qt - 1 - x
        if not causal:
            out.append((qt, 0, (skv - 1) // BLOCK_K))
            continue
        qp_lo = qt * BLOCK_Q + off
        qp_hi = min((qt + 1) * BLOCK_Q, sq) - 1 + off
        key_hi = min(qp_hi, skv - 1)
        key_lo = max(qp_lo - window, 0) if window is not None else 0
        out.append((qt, key_lo // BLOCK_K, key_hi // BLOCK_K))
    return out


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("flash_attention"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
        lib.flash_attention_launch.restype = _I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None,
                    causal: bool = True) -> torch.Tensor:
    """CUDA flash attention forward, causal or (``causal=False``) not:
    bf16 q [B,Sq,H,Dqk], k [B,Skv,Hkv,Dqk], v [B,Skv,Hkv,Dv] -> bf16
    [B,Sq,H,Dv] (see ``ref.flash_attention_ref``); ``(Dqk, Dv)`` one of
    ``HEAD_DIMS``, or of ``NONCAUSAL_HEAD_DIMS`` when not causal."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "torch.bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    check_shapes(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dims = HEAD_DIMS if causal else NONCAUSAL_HEAD_DIMS
    if (D, Dv) not in dims:
        raise ValueError(f"head dims (q/k {D}, v {Dv}) not in {dims}"
                         + ("" if causal else " (not causal)"))
    if H > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or H={H} exceeds the kernel's grid")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    o = q.new_empty((B, Sq, H, Dv))
    if o.numel() == 0:
        return o
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Sq, Skv, H, Hkv, D, Dv, -1 if window is None else window,
        int(causal), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _MAP_ERROR:
        raise RuntimeError(f"flash_attention: CUDA refused a TMA tensor "
                           f"map (CUresult {err - _MAP_ERROR}; 0: no "
                           f"cuTensorMapEncodeTiled)")
    if err:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    _launches["flash_attention"] += 1
    return o
