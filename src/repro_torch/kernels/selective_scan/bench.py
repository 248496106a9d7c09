"""The selective_scan kernel alone on the card: build, check, time.

Run from the root of a checkout on a host with one NVIDIA H100:

    PYTHONPATH=src python3 -m repro_torch.kernels.selective_scan.bench

It builds only this kernel (``_build.build_all(["selective_scan"])``, with
``nvcc``'s ``-Xptxas -v`` report) and then:

1. counts ``MUFU.EX2``, ``SHFL``, ``LDG``, ``LDGSTS``, ``LDS``, ``STS`` and
   ``STG`` in each ``selective_scan_kernel<K>`` of the built library
   (``cuobjdump -sass``), and from them the shuffles a channel-step
   (each step of a thread takes K ``MUFU.EX2``, one a state, so a
   channel's 16 states take 16 × SHFL / MUFU.EX2);
2. prints each variant's launch plan at the serving slice: channels and
   threads a block, shared bytes, resident blocks an SM (occupancy API),
   grid and waves;
3. holds every variant (K = 2, 4, 8 states a thread, planned blocks; and
   K = 4 with 64-channel blocks) bitwise to ``selective_scan_ref`` on the
   cases of :func:`cases`: ``chip_smoke.py`` phase 9's (Hymba's and
   falcon-mamba's prefill shapes among them), ``Di % 4 != 0`` and
   ``T % CHUNK_STEPS != 0``;
4. times each variant at ``[4, 4096, 3200, 16]`` by CUDA events beside
   the bound of :func:`scan_bound_ms`.

It exits with 1 if any variant differs from the plain version in any
bit.  ``chip_smoke.py`` phase 9 calls :func:`cases`, :func:`run_cases`
and :func:`scan_bound_ms`, so the cases and the bound live here.

With ``--backward`` it builds only the backward kernel
(``selective_scan_bwd``, with ``-Xptxas -v``'s registers) and instead
counts the same opcodes and ``BAR`` in its two kernels (and the
``MUFU.EX2`` a state-step), prints its launch plan at both training
shapes (:func:`bwd_plans`: channels, warps and shared bytes a block,
registers, resident blocks an SM, grid, waves, the busiest SM's warps
beside the mean), holds it to ``selective_scan_bwd_ref`` on the card at
:data:`BWD_CASES` (Hymba's and falcon-mamba's training shapes, an odd
shape with ``h0`` and ``dh_T`` non-zero, small ragged ones, and shapes
one channel past a multiple of the block width): all six gradients bit
for bit (the kernel sums in the plain version's fixed orders, with no
atomics), and two runs of the kernel with the same bits; then times it
at each training shape beside the plain backward's time and
:func:`scan_bwd_bound_ms`.  ``chip_smoke.py`` phase 28 calls
:func:`run_bwd_cases` and :func:`time_bwd`, so those live here too.
"""
from __future__ import annotations

import argparse
import collections
import faulthandler
import json
import re
import subprocess
import sys
import time
from typing import Optional

import torch

from .. import _build
from ..flash_attention.bench import EX2_PER_S, HBM_BYTES_PER_S, cuda_ms
from ..minplus.bench import FP32_OPS_PER_S, _sass
from . import kernel
from .ref import (SUB_STEPS, scan_bwd_work, scan_work, selective_scan_bwd_ref,
                  selective_scan_ref)

__all__ = ["scan_bound_ms", "cases", "inputs", "run_cases", "sass_counts",
           "time_variants", "variants", "scan_bwd_bound_ms", "BWD_CASES",
           "bwd_inputs", "bwd_plans", "run_bwd_cases", "main"]

SERVE = (4, 4096, 3200)          # Hymba-1.5B's prefill: batch, tokens, Di
# falcon-mamba-7b's prefill (Di 8,192) at one request and at the serving
# batch of chip_smoke.py phase 21
FALCON = ((1, 4096, 8192), (2, 4096, 8192))
STATE = kernel.STATE


def scan_bound_ms(b: int, t: int, di: int, n: int = STATE) -> dict:
    """The least ms of one scan, the largest of three times: u, dt, A, B,
    C, h0 read once and y, h_T written once over the memory rate; 7
    float32 operations per (b, t, channel, state) at 67 TFLOP/s; and one
    MUFU ``ex2`` (the expf) per (b, t, channel, state) at 16 an SM a
    clock.  Returns ``{"bytes_ms", "fp32_ms", "ex2_ms", "bound_ms",
    "bound_by", "limit"}``: ``bound_by`` is "bytes" or "operations",
    ``limit`` names the term."""
    w = scan_work(b, t, di, n)
    terms = {"bytes": w["bytes"] / HBM_BYTES_PER_S * 1e3,
             "float32": w["flops"] / FP32_OPS_PER_S * 1e3,
             "MUFU ex2": w["ex2"] / EX2_PER_S * 1e3}
    limit = max(terms, key=terms.get)
    return {"bytes_ms": terms["bytes"], "fp32_ms": terms["float32"],
            "ex2_ms": terms["MUFU ex2"], "bound_ms": terms[limit],
            "bound_by": "bytes" if limit == "bytes" else "operations",
            "limit": limit}


# the backward's cases, (B, T, Di, h0 and dh_T non-zero): Hymba-1.5B's
# and falcon-mamba-7b's training shapes (chip_smoke.py phase 28, 2 x
# 4,096), an odd shape, then T % CHUNK_STEPS != 0 with short tails, one
# sub-chunk, T = 1, Di below one block, and Di one past a multiple of the
# block width with Di % 4 != 0
BWD_TRAIN = ((2, 4096, 3200), (2, 4096, 8192))
BWD_CASES = [(*s, False) for s in BWD_TRAIN] + [
    (1, 1000, 4100, True), (2, 65, 52, True), (3, 9, 17, True),
    (1, 1, 6, True), (2, 130, 33, False), (2, 130, 2113, True)]


def scan_bwd_bound_ms(b: int, t: int, di: int, n: int = STATE) -> dict:
    """The least ms of one scan backward, the largest of three times: u,
    dt, dy, A, B, C, h0, dh_T read once and du, ddt, dA, dB, dC, dh0
    written once over the memory rate; 18 float32 operations per (b, t,
    channel, state) at 67 TFLOP/s (4 to rebuild the state, 14 to walk
    back: g, its products with B, a and h_{t-1}, dA's product and sum,
    A q, the terms of dB and dC, and their shares of the four sums); and
    two MUFU ``ex2`` per (b, t, channel, state) at 16 an SM a clock (one
    to find the states at chunk starts, one to rebuild them).  Returns
    :func:`scan_bound_ms`'s keys."""
    w = scan_bwd_work(b, t, di, n)
    terms = {"bytes": w["bytes"] / HBM_BYTES_PER_S * 1e3,
             "float32": w["flops"] / FP32_OPS_PER_S * 1e3,
             "MUFU ex2": w["ex2"] / EX2_PER_S * 1e3}
    limit = max(terms, key=terms.get)
    return {"bytes_ms": terms["bytes"], "fp32_ms": terms["float32"],
            "ex2_ms": terms["MUFU ex2"], "bound_ms": terms[limit],
            "bound_by": "bytes" if limit == "bytes" else "operations",
            "limit": limit}


def bwd_inputs(gen: torch.Generator, b: int, t: int, di: int,
               nonzero: bool):
    """Seeded (u, dt, A, Bc, Cc, h0, dy, dh_T) on ``gen``'s device:
    :func:`inputs`, then dy a standard normal and dh_T one too or None;
    h0 non-zero with ``nonzero``."""
    dev = gen.device
    args = inputs(gen, b, t, di, not nonzero)
    dy = torch.randn((b, t, di), generator=gen, device=dev)
    dh_T = torch.randn((b, di, STATE), generator=gen, device=dev) \
        if nonzero else None
    return (*args, dy, dh_T)


_BWD_NAMES = ("du", "ddt", "dA", "dB", "dC", "dh0")


def bwd_plans() -> dict:
    """The backward's launch plan at each training shape of
    :data:`BWD_TRAIN` (``kernel.bwd_plan``) with its warps a block, its
    waves and the warps its busiest SM holds over the launch beside the
    mean over the SMs; printed and returned by label."""
    out = {}
    for b, t, di in BWD_TRAIN:
        p = kernel.bwd_plan(b, di)
        warps = p["threads"] // 32
        slots = p["sms"] * p["blocks_per_sm"]
        busiest = (-(-p["grid"] // p["sms"]) if p["grid"] <= slots else
                   -(-p["grid"] // slots) * p["blocks_per_sm"]) * warps
        rec = dict(p, warps=warps, waves=p["grid"] / slots,
                   busiest_sm_warps=busiest,
                   mean_sm_warps=p["grid"] * warps / p["sms"])
        label = f"[{b},{t},{di},{STATE}]"
        print(f"selective_scan_bwd plan {label}: {rec}", flush=True)
        out[label] = rec
    return out


def run_bwd_cases(gen: torch.Generator, case_list=None) -> list:
    """Each case of ``case_list`` (default :data:`BWD_CASES`) through
    ``kernel.selective_scan_bwd`` twice and ``selective_scan_bwd_ref``
    once on ``gen``'s device.  Raises unless all six gradients equal the
    plain version's bit for bit and the two kernel runs have the same
    bits.  Returns ``[{"label", "max_abs_err", "plain_ms": the plain
    backward's one call by CUDA events, "args": the inputs at the
    training shapes of ``BWD_TRAIN``, else None}]``."""
    out = []
    for b, t, di, nonzero in BWD_CASES if case_list is None else case_list:
        args = bwd_inputs(gen, b, t, di, nonzero)
        label = f"[{b},{t},{di},{STATE}]" + (" h0, dh_T" if nonzero else "")
        got = kernel.selective_scan_bwd(*args)
        again = kernel.selective_scan_bwd(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = selective_scan_bwd_ref(*args)
        end.record()
        torch.cuda.synchronize()
        worst = max((float((g - w).abs().max()) for g, w in zip(got, want)
                     if w.numel()), default=0.0)
        bad = [n for n, g, w in zip(_BWD_NAMES, got, want)
               if not torch.equal(g.view(torch.int32), w.view(torch.int32))]
        same = all(torch.equal(g.view(torch.int32), h.view(torch.int32))
                   for g, h in zip(got, again))
        print(f"selective_scan_bwd {label}: max abs error {worst}; not bit "
              f"for bit {bad}; two runs the same bits: {same}", flush=True)
        if bad or not same:
            raise AssertionError(f"selective_scan_bwd differs from its "
                                 f"plain version at {label}: {bad}, "
                                 f"repeatable {same}")
        out.append({"label": label, "max_abs_err": worst,
                    "plain_ms": start.elapsed_time(end),
                    "args": args if (b, t, di) in BWD_TRAIN else None})
        del got, again, want
    return out


def time_bwd(rec: dict) -> dict:
    """The kernel's ms a call on a case of :func:`run_bwd_cases` by CUDA
    events, beside that case's plain ms and :func:`scan_bwd_bound_ms`."""
    args = rec["args"]
    b, t, di = args[0].shape
    ms = cuda_ms(lambda: kernel.selective_scan_bwd(*args), iters=10,
                 warmup=2)
    bnd = scan_bwd_bound_ms(b, t, di)
    print(f"selective_scan_bwd {rec['label']}: kernel {ms:.6f} ms a call, "
          f"bound {bnd['bound_ms']:.6f} ms ({bnd['limit']}; bytes "
          f"{bnd['bytes_ms']:.6f}, float32 {bnd['fp32_ms']:.6f}, MUFU ex2 "
          f"{bnd['ex2_ms']:.6f}), {100 * bnd['bound_ms'] / ms:.2f}% of the "
          f"bound; plain {rec['plain_ms']:.3f} ms; no PyTorch call "
          "computes this scan", flush=True)
    return dict(ms=ms, plain_ms=rec["plain_ms"], library_ms=None, **bnd)


def cases() -> list:
    """``[(B, T, Di, h0 zero)]``: the serving slice first (the timed one,
    Di % 4 == 0, T a multiple of the staged run), falcon-mamba's prefill
    shapes (``FALCON``), then ``chip_smoke.py`` phase 9's ragged shapes,
    then ``T % CHUNK_STEPS != 0`` with ``Di % 4 == 0`` and not, T shorter
    than one run, and T = 1."""
    b, t, di = SERVE
    tc = kernel.CHUNK_STEPS
    return [(b, t, di, True)] + [(*f, True) for f in FALCON] + [
            (3, 77, 50, False), (1, 1000, 3211, False),
            (2, tc + 1, 52, False), (2, 3 * tc + 5, 17, False),
            (3, 5, 130, False), (1, 1, 6, False)]


def inputs(gen: torch.Generator, b: int, t: int, di: int, h0_zero: bool):
    """Seeded float32 (u, dt, A, Bc, Cc, h0) on ``gen``'s device: dt in
    [0.001, 0.1], A the Mamba initialisation -(1..16)."""
    dev = gen.device
    u = torch.randn((b, t, di), generator=gen, device=dev)
    dt = torch.rand((b, t, di), generator=gen, device=dev) * 0.099 + 1e-3
    A = -torch.exp(torch.log(torch.arange(
        1, STATE + 1, dtype=torch.float32, device=dev))).expand(di, STATE)
    Bc, Cc = (torch.randn((b, t, STATE), generator=gen, device=dev)
              for _ in range(2))
    h0 = torch.zeros((b, di, STATE), device=dev) if h0_zero else \
        torch.randn((b, di, STATE), generator=gen, device=dev)
    return u, dt, A.contiguous(), Bc, Cc, h0


def variants() -> list:
    """``[(k, channels)]`` the bench holds and times: each K with its
    planned blocks, then K = 4 with 64-channel blocks (200 blocks on 132
    SMs at the serving slice: two waves, the second two thirds full)."""
    return [(k, 0) for k in kernel.VARIANTS] + [(4, 64)]


def _label(variant) -> str:
    if variant is None:
        return "main path"
    k, ch = variant
    return f"K={k}" + (f", {ch} channels a block" if ch else "")


def run_cases(gen: torch.Generator, variant_list=(None,),
              exact: bool = True) -> list:
    """Every case of :func:`cases` through each of ``variant_list`` (None:
    the wrapper the main path calls; ``(k, channels)``:
    ``kernel.selective_scan_variant``) and once through the plain version,
    on ``gen``'s device.  Raises on the first output that differs from
    the plain version in any bit when ``exact``.  Returns ``[{"label",
    "variant", "max_abs_err", "scale", "same", "args"}]`` (``scale``: the
    plain outputs' largest magnitude; ``args`` only for the first case,
    the serving slice, for timing)."""
    out = []
    for i, (b, t, di, h0_zero) in enumerate(cases()):
        args = inputs(gen, b, t, di, h0_zero)
        yr, hr = selective_scan_ref(*args)
        scale = max(float(yr.abs().max()), float(hr.abs().max()))
        label = f"[{b},{t},{di},{STATE}]"
        for v in variant_list:
            y, h = kernel.selective_scan(*args) if v is None else \
                kernel.selective_scan_variant(*args, *v)
            torch.cuda.synchronize()
            err = max(float((y - yr).abs().max()),
                      float((h - hr).abs().max()))
            same = torch.equal(y, yr) and torch.equal(h, hr)
            verdict = "bitwise equal" if same else "NOT bitwise equal"
            print(f"selective_scan {label} {_label(v)}: max_abs_err "
                  f"{err!r}, {verdict}", flush=True)
            if exact and not same:
                raise AssertionError(f"selective_scan ({_label(v)}) differs "
                                     f"from its plain version at {label}")
            out.append({"label": label, "variant": v, "max_abs_err": err,
                        "scale": scale, "same": same,
                        "args": args if i == 0 else None})
            del y, h
        del yr, hr
        if i:
            del args
    return out


# one SASS instruction: its address comment, a predicate, the opcode with
# its modifiers
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")
_COUNTED = ("MUFU.EX2", "SHFL", "LDG", "LDGSTS", "UBLKCP", "UTMALDG",
            "LDS", "STS", "STG", "BAR")
_KERNEL = re.compile(r"(selective_scan_(?:bwd_(?:sum_)?)?kernel)"
                     r"(?:ILi(\d+)E)?")
_BWD_K = 4             # states a lane of the backward kernel (csrc kK)


def sass_counts(path) -> Optional[dict]:
    """``{label: {"MUFU.EX2": n, "SHFL": n, "LDG": n, "LDGSTS": n,
    "UBLKCP": n, "UTMALDG": n, "LDS": n, "STS": n, "STG": n, "BAR": n,
    "total": n, ...}}`` over the library at ``path`` (``cuobjdump
    -sass``; static counts, each opcode by its name before the first
    dot, ``MUFU.EX2`` whole), for each ``selective_scan_kernel<K>`` (with
    ``shfl_per_channel_step``: each step of a thread takes K
    ``MUFU.EX2``, so a channel's 16 states take 16 × SHFL / MUFU.EX2),
    the backward's ``selective_scan_bwd_kernel`` (with
    ``ex2_per_state_step``: each of its two walks is one unrolled
    sub-chunk of ``SUB_STEPS`` steps of 4 states, so MUFU.EX2 / (8 × 4))
    and ``selective_scan_bwd_sum_kernel``; None without ``cuobjdump``."""
    sass = _sass(path)
    if sass is None:
        return None
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        head = func.split("\n", 1)[0]
        m = _KERNEL.search(head)
        if m is None:
            continue
        name = m.group(1)
        label = f"{name}<{m.group(2)}>" if m.group(2) else name
        ops = _INSN.findall(func)
        base = collections.Counter(op.split(".")[0] for op in ops)
        rec = {op: (sum(o.startswith("MUFU.EX2") for o in ops)
                    if op == "MUFU.EX2" else base.get(op, 0))
               for op in _COUNTED}
        rec["total"] = len(ops)
        if name == "selective_scan_kernel":
            rec["shfl_per_channel_step"] = (
                STATE * rec["SHFL"] / rec["MUFU.EX2"] if rec["MUFU.EX2"]
                else None)
        elif name == "selective_scan_bwd_kernel":
            rec["ex2_per_state_step"] = rec["MUFU.EX2"] / (SUB_STEPS
                                                           * _BWD_K)
        out[label] = rec
    return out


def time_variants(args, variant_list, iters: int = 20) -> dict:
    """Per-launch ms of each ``(k, channels)`` of ``variant_list`` on
    ``args`` (the kernel's variant entry point on preallocated outputs,
    back to back, CUDA events) with its launch plan and waves."""
    u, dt, A, Bc, Cc, h0 = args
    b, t, di = u.shape
    y = torch.empty_like(u)
    h_t = torch.empty_like(h0)
    lib = kernel._lib()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (u, dt, A, Bc, Cc, h0, y, h_t)]
    out = {}
    for k, ch in variant_list:
        p = kernel.plan(k, b, di, ch)
        slots = p["sms"] * p["blocks_per_sm"]
        waves = p["grid"] / slots
        busiest = (-(-p["grid"] // p["sms"]) if p["grid"] <= slots else
                   -(-p["grid"] // slots) * p["blocks_per_sm"]) \
            * p["threads"] // 32

        def launch():
            err = lib.selective_scan_launch_variant(*ptrs, b, t, di, k, ch,
                                                    stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        ms = cuda_ms(launch, iters=iters, warmup=3)
        out[_label((k, ch))] = dict(ms=ms, waves=waves,
                                    busiest_sm_warps=busiest, **p)
        print(f"{_label((k, ch))}: {ms:.6f} ms per launch; plan {p}, "
              f"{waves:.3f} waves, the busiest SM holds {busiest} warps "
              f"({b * di * STATE // k / 32 / p['sms']:.2f} a perfect split)",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--watchdog", type=float, default=600.0,
                    help="seconds after which the bench dumps its stack "
                         "and exits (a kernel that hangs)")
    ap.add_argument("--backward", action="store_true",
                    help="build, check and time the backward kernel "
                         "instead")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("selective_scan bench: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(opts.watchdog, exit=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip() or 'not available'}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    if opts.backward:
        return _main_backward(opts)
    t0 = time.perf_counter()
    rec = _build.build_all(["selective_scan"])["selective_scan"]
    print(f"built {rec['path'].name} in {time.perf_counter() - t0:.2f} s")
    print(rec["log"].strip())
    counts = sass_counts(rec["path"])
    print(f"SASS: {json.dumps(counts)}", flush=True)
    main_k = kernel.plan(0, *SERVE[::2])["k"]
    print(f"main path: K = {main_k}")
    vl = variants()
    gen = torch.Generator(device="cuda").manual_seed(9)
    try:
        results = run_cases(gen, [None] + vl)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    args = results[0]["args"]
    bound = scan_bound_ms(*SERVE)
    print(f"bound at {list(SERVE) + [STATE]}: {bound}")
    timed = time_variants(args, vl)
    for label, r in timed.items():
        print(f"  {label}: {100 * bound['bound_ms'] / r['ms']:.2f}% of the "
              f"bound")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"sass": counts, "bound": bound, "main_k": main_k,
                      "timed": timed,
                      "max_abs_err": max(r["max_abs_err"] for r in results)}))
    return 0


def _main_backward(opts) -> int:
    """``--backward``: build, check and time ``selective_scan_bwd``."""
    t0 = time.perf_counter()
    rec = _build.build_all(["selective_scan_bwd"])["selective_scan_bwd"]
    print(f"built {rec['path'].name} in {time.perf_counter() - t0:.2f} s")
    print(rec["log"].strip())
    counts = sass_counts(rec["path"])
    print(f"SASS: {json.dumps(counts)}", flush=True)
    plans = bwd_plans()
    gen = torch.Generator(device="cuda").manual_seed(28)
    try:
        results = run_bwd_cases(gen)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    timed = {r["label"]: time_bwd(r) for r in results if r["args"]}
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"sass": counts, "plans": plans, "timed": timed,
                      "max_abs_err": {r["label"]: r["max_abs_err"]
                                      for r in results}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
