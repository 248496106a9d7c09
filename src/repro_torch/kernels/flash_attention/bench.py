"""The flash_attention kernel alone on the card: build, check, time.

Run from the root of a checkout on a host with one NVIDIA H100:

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.bench

It builds only this kernel (``_build.build_all(["flash_attention"])``,
with ``nvcc``'s ``-Xptxas -v`` report), holds it to its plain version on
the cases of ``chip_smoke.py``'s phase 9 (``ref.compare_bf16``:
Hymba-1.5B's full and 2,048-window layers of 4 x 4,096 tokens, ragged
and D = 16 shapes, then ``CASES_D128``: qwen3-1.7b's and
qwen3-moe-235b-a22b's full layers at head dim 128 and ragged D = 128
shapes, then ``CASES_MLA``: deepseek-v3-671b's layer with queries and
keys 192 wide and values 128 wide, and ragged shapes of the same dims,
then ``CASES_CROSS``: the non-causal layers of llama-3.2-vision-90b and
seamless-m4t-medium, the causal self layers of the same two models, and
ragged non-causal shapes), times the serving shapes beside the plain
version, SDPA (and the SDPA backend that ran) and the bound, and counts
the ``HGMMA`` and ``UTMALDG`` instructions of the built library's
kernels (``cuobjdump -sass``).  It
exits with 1 if a case fails or either count is 0.  ``chip_smoke.py``
phase 9 calls :func:`run_cases`, so the cases and the bound live here.

``--tc-sums-only`` then builds the kernel a second time with
``FLASH_ATTENTION_TC_SUMS_ONLY`` (s, the row max and every p from the
tensor cores' sums alone, none from the float32 chain) and runs the same
cases and timings on it, reporting and not failing the cases it fails:
what the kernel's exact sums cost and what they buy.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

import torch

from .. import _build
from . import kernel as fa
from .ref import attention_work, compare_bf16, flash_attention_ref

__all__ = ["cases", "CASES_D128", "CASES_MLA", "CASES_CROSS", "bound_ms",
           "run_cases", "sass_counts", "main"]

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
# MUFU ex2: 16 a clock on each of the 132 SMs at the 1.98 GHz boost clock
# (NVIDIA's Hopper white paper and data sheet)
EX2_PER_S = 16 * 132 * 1.98e9
SERVE_BATCH, SERVE_PROMPT = 4, 4096


def cases(cfg, batch: int = SERVE_BATCH, seq: int = SERVE_PROMPT) -> list:
    """``[(B, Sq, Skv, H, Hkv, D, window)]``: the serving slice's full and
    windowed layers first (the timed ones), then ragged and D = 16
    shapes.  A case may add an eighth entry, the values' width where it
    is not D (``CASES_MLA``), and a ninth, False where it is not causal
    (``CASES_CROSS``)."""
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    return [(batch, seq, seq, H, Hkv, D, None), (batch, seq, seq, H, Hkv, D, W),
            (1, 1000, 1000, H, Hkv, D, 300), (2, 77, 333, H, Hkv, D, None),
            (1, 130, 130, 5, 1, 16, 5), (3, 200, 200, 5, 1, 16, 64)]


# head dim 128: a full causal layer of qwen3-1.7b's prefill (4 x 4,096,
# 16 heads on 8, GQA group 2) and of qwen3-moe-235b-a22b's (2 x 4,096, 64
# heads on 4, group 16) first (the timed ones), then ragged shapes: a
# window, queries at the end of a longer key range, and rows past Sq
CASES_D128 = [(4, 4096, 4096, 16, 8, 128, None),
              (2, 4096, 4096, 64, 4, 128, None),
              (1, 1000, 1100, 16, 2, 128, 300),
              (2, 77, 333, 64, 4, 128, None)]

# MLA: deepseek-v3-671b's prefill layer (2 x 4,096, 128 heads, group 1,
# queries and keys 192 wide, values 128 wide) first, then ragged shapes
# of the same dims: Sq not a multiple of 64 (the two timed ones), and
# queries at the end of a longer key range
CASES_MLA = [(2, 4096, 4096, 128, 128, 192, None, 128),
             (1, 1000, 1000, 16, 16, 192, None, 128),
             (2, 77, 333, 128, 128, 192, None, 128)]


# not causal: llama-3.2-vision-90b's cross layer (2 x 4,096 queries over
# 1,600 vision tokens, 64 heads on 8 of 128), seamless-m4t-medium's
# encoder layer (4 x 1,024 frames, 16 heads of 64, group 1) and its cross
# layer (4 x 4,096 over 1,024 frames), then the causal self layers of the
# same two models (llama's [2, 4,096, 64 / 8, 128], seamless's decoder
# [4, 4,096, 16, 64]), timed so that each model's path gets its own
# bound; then ragged non-causal shapes: Skv not a multiple of 64 (1,000,
# 1,601), Sq above and below Skv, Sq not a multiple of 64
CASES_CROSS = [(2, 4096, 1600, 64, 8, 128, None, 128, False),
               (4, 1024, 1024, 16, 16, 64, None, 64, False),
               (4, 4096, 1024, 16, 16, 64, None, 64, False),
               (2, 4096, 4096, 64, 8, 128, None, 128, True),
               (4, 4096, 4096, 16, 16, 64, None, 64, True),
               (1, 1000, 1000, 16, 2, 128, None, 128, False),
               (2, 200, 1601, 16, 16, 64, None, 64, False),
               (2, 1601, 77, 8, 2, 64, None, 64, False),
               (1, 130, 1000, 64, 8, 128, None, 128, False),
               (3, 77, 33, 4, 4, 64, None, 64, False)]
N_TIMED_CROSS = 5


def bound_ms(b, sq, skv, h, hkv, d, window, dv=None, causal=True) -> tuple:
    """(least ms, "bytes" or "operations"): q, k, v read once and o
    written once over the memory rate, against 2 (d + dv) operations per
    live (query, key) pair (``q·k`` and ``p·v``; ``dv`` = d unless
    given) at the bf16 tensor-core rate."""
    ops, n_bytes = attention_work(b, sq, skv, h, hkv, d, window, dv, causal)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ex2_ms(b, sq, skv, h, window, causal=True) -> float:
    """The least ms the card's MUFU units take for one exponential per
    (query, key) pair the kernel visits (whole 64 x 64 tiles,
    ``kernel.key_tiles``): a ceiling beside the bound, which counts the
    tensor cores' operations."""
    n_tiles = sum(hi - lo + 1 for _, lo, hi in
                  fa.key_tiles(sq, skv, window, causal))
    return b * h * n_tiles * fa.BLOCK_Q * fa.BLOCK_K / EX2_PER_S * 1e3


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back
    calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa(q, k, v, window: Optional[int], causal: bool = True):
    """PyTorch's fused attention on the same function (the yardstick; the
    port never calls it), the window as a boolean mask."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - (window + 1))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def sdpa_backend(fn) -> str:
    """The SDPA backend that runs ``fn()``: the first, in PyTorch's
    default priority order (flash, memory-efficient, the plain math),
    that takes it alone, or "none"."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # a refusal's reasons
                fn()
        except RuntimeError:
            continue
        return backend.name.lower()
    return "none"


def run_cases(cfg, gen: torch.Generator, batch: int = SERVE_BATCH,
              seq: int = SERVE_PROMPT, n_timed: int = 2,
              strict: bool = True, case_list=None) -> dict:
    """Every case of ``case_list`` (default :func:`cases` of ``cfg``)
    through the kernel and the plain version on ``gen``'s device, held
    together by ``compare_bf16``; raises on the first case that fails
    when ``strict``.  The first ``n_timed`` cases are timed.  Returns
    ``{"max_abs_err": x, "failed": [labels], "timed": {case index:
    {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
    "sdpa_backend"}}}``."""
    dev = gen.device
    errs, timed, failed = [], {}, []
    if case_list is None:
        case_list = cases(cfg, batch, seq)
    for i, case in enumerate(case_list):
        b, sq, skv, h, hkv, d, win = case[:7]
        dv = case[7] if len(case) > 7 else d
        causal = case[8] if len(case) > 8 else True
        q, k, v = [torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, skv, hkv, d),
                                 (b, skv, hkv, dv))]
        got = fa.flash_attention(q, k, v, window=win, causal=causal)
        want = flash_attention_ref(q, k, v, window=win, causal=causal)
        torch.cuda.synchronize()
        # each element within one bf16 ulp of its own value plus one flip
        # of one p's rounding in its row, and few elements differing at all
        # (compare_bf16 gives the reasons)
        cmp = compare_bf16(got, want, q, k, v, window=win, causal=causal)
        dims = f"{d}" if dv == d else f"{d}/{dv}"
        label = (f"[{b},{sq},{skv},{h},{hkv},{dims}] "
                 + (f"window {win}" if causal else "not causal"))
        print(f"flash_attention {label}: max_abs_err {cmp['max_abs_err']!r}"
              f", worst error {cmp['worst']!r} of its element's bound, "
              f"{cmp['n_diff']} of {got.numel()} outputs differ (at most "
              f"{cmp['n_allowed']})", flush=True)
        if not cmp["ok"]:
            if strict:
                raise AssertionError(f"flash_attention differs from its "
                                     f"plain version at {label}")
            failed.append(label)
            print(f"  FAILS compare_bf16 at {label}")
        errs.append(cmp["max_abs_err"])
        if i < n_timed:
            lib = _sdpa(q, k, v, win, causal)
            lib_err = float((lib().transpose(1, 2).float() - want.float())
                            .abs().max())
            backend = sdpa_backend(lib)
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, window=win,
                                                    causal=causal),
                         iters=10, warmup=2)
            plain = cuda_ms(lambda: flash_attention_ref(
                q, k, v, window=win, causal=causal), iters=3, warmup=1)
            lib_ms = cuda_ms(lib, iters=10, warmup=2)
            bnd, by = bound_ms(b, sq, skv, h, hkv, d, win, dv, causal)
            timed[i] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                            bound_ms=bnd, bound_by=by, sdpa_backend=backend)
            print(f"  kernel {ms:.6f} ms per launch, bound {bnd:.6f} ms "
                  f"({by}, {100 * bnd / ms:.2f}% of the bound; MUFU ex2 "
                  f"ceiling {ex2_ms(b, sq, skv, h, win, causal):.6f} ms); "
                  f"plain {plain:.6f} ms; SDPA {lib_ms:.6f} ms ({backend} "
                  f"backend; max_abs_err against the plain version "
                  f"{lib_err!r})", flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "failed": failed, "timed": timed}


def sass_counts(path) -> Optional[dict]:
    """``{"HGMMA": n, "UTMALDG": n}`` over the ``flash_attention_kernel``
    functions of the library at ``path``, from ``cuobjdump -sass``; None
    without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {"HGMMA": 0, "UTMALDG": 0}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if "flash_attention_kernel" in func.split("\n", 1)[0]:
            for op in counts:
                counts[op] += len(re.findall(rf"\b{op}\b", func))
    return counts


@contextlib.contextmanager
def _kernel_library(path):
    """The kernel wrapper launches from the library at ``path`` inside."""
    lib = fa._bind(ctypes.CDLL(str(path)))
    saved = fa._lib
    fa._lib = lambda: lib
    try:
        yield
    finally:
        fa._lib = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tc-sums-only", action="store_true",
                    help="also run the kernel built without its exact sums")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention bench: no CUDA device", file=sys.stderr)
        return 2
    from ...configs import get_config
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip() or 'not available'}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    rec = _build.build_all(["flash_attention"])["flash_attention"]
    print(f"built {rec['path'].name} in {time.perf_counter() - t0:.2f} s")
    print(rec["log"].strip())
    counts = sass_counts(rec["path"])
    print(f"SASS of flash_attention_kernel: {counts}")
    cfg = get_config("hymba-1.5b")
    gen = torch.Generator(device="cuda").manual_seed(9)
    try:
        out = run_cases(cfg, gen)
        print(json.dumps(out))
        print("-- head dim 128: qwen3-1.7b's and qwen3-moe-235b-a22b's layers")
        print(json.dumps(run_cases(cfg, gen, case_list=CASES_D128)))
        print("-- MLA, q/k 192 and v 128: deepseek-v3-671b's layer")
        print(json.dumps(run_cases(cfg, gen, case_list=CASES_MLA)))
        print("-- not causal: llama-3.2-vision-90b's and "
              "seamless-m4t-medium's layers")
        print(json.dumps(run_cases(cfg, gen, n_timed=N_TIMED_CROSS,
                                   case_list=CASES_CROSS)))
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    if args.tc_sums_only:
        define = "FLASH_ATTENTION_TC_SUMS_ONLY"
        rec = _build.build_all(["flash_attention"], (define,))
        print(f"\n-- built with {define}: the tensor cores' sums alone")
        with _kernel_library(rec["flash_attention"]["path"]):
            for case_list in (None, CASES_D128, CASES_MLA, CASES_CROSS):
                abl = run_cases(
                    cfg, torch.Generator(device="cuda").manual_seed(9),
                    strict=False, case_list=case_list)
                print(json.dumps(abl))
    return 0 if counts and all(counts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
