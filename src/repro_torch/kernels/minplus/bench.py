"""The int16 min-plus kernel alone on the card: DPX issue rate, checks,
times.

Run from the root of a checkout on a host with one NVIDIA H100:

    PYTHONPATH=src python3 -m repro_torch.kernels.minplus.bench

It builds only ``minplus`` (``_build.build_all(["minplus"])``, with
``nvcc``'s ``-Xptxas -v`` report) and then:

1. measures the issue rate of ``__viaddmin_s16x2`` and ``__viaddmin_s32``
   (and of the float32 kernel's add and min) per SM per clock, by the
   probe of ``csrc/dpx_probe.cuh``: independent chains in registers on
   every SM, the clocks read by ``clock64`` and the time by CUDA events;
2. counts the instructions of ``minplus_hops_kernel`` and of the probe's
   loops in the built library (``cuobjdump -sass``): ``VIADDMNMX``, and
   every other instruction per ``VIADDMNMX``;
3. holds ``minplus_hops`` bitwise to its plain version on ragged and odd
   shapes at "no path" shares 0 / 0.2 / 0.5 / 0.9 / 1.0 and at N = 921,
   and checks that it writes nothing outside its output;
4. times it per launch (CUDA events) at N = 921 beside the plain version,
   and at the products of both Figure-6 table builds (leaf rows and the
   other rows of a squaring of the N x N hop matrix), beside the bound at
   the measured DPX rate and the float32 kernel's bound.

It exits with 1 if a case differs or the kernel has no ``VIADDMNMX``.
``chip_smoke.py`` phase 3 calls :func:`probe`, :func:`run_cases`,
:func:`time_921` and :func:`hops_bound_ms`, so the cases and the bound
live here.
"""
from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..flash_attention.bench import cuda_ms
from . import kernel
from .ref import HOPS_INF, HOPS_LIMIT, minplus_hops_ref, padded_hops

__all__ = ["probe", "hops_bound_ms", "fp32_bound_ms", "cases", "run_cases",
           "sass_counts", "time_921", "time_fig6", "main"]

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
BOOST_HZ = 1.98e9                # H100 SXM boost clock (data sheet)
N_SM = 132                       # H100 SXM streaming multiprocessors
# probe ops: (name, y, z, start) as int32 bit patterns; op 2 is float32
_PROBE = {0: ("viaddmin_s16x2", 0x00010001, 0x3FFF3FFF, 0),
          1: ("viaddmin_s32", 1, 1 << 30, 0),
          2: ("fadd+fmnmx (float32)", 0x3F800000, 0x4E6E6B28, 0)}
# lanes (min, +) triples per probe step of each op
_TRIPLES = {0: 2, 1: 1, 2: 1}
# (N switches, N1 leaves) of the Figure-6 fabrics' table builds
FIG6 = {"fig6.mrls_f1": (8748, 5832), "fig6.ft50": (23328, 5832)}


def probe(op: int, iters: int = 10000) -> dict:
    """Issue rate of probe op ``op`` on every SM of device 0: ``per_clock``
    steps per SM per clock (from ``clock64``), ``per_s`` steps per second
    on the card (CUDA events), the SM clock in GHz they imply, and
    ``triples_per_clock`` (int16 lanes count twice)."""
    lib = kernel._lib()
    name, y, z, start = _PROBE[op]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    occ = lib.dpx_probe_occupancy(op)
    if occ <= 0:
        raise RuntimeError(f"probe op {op}: occupancy query failed ({occ})")
    threads, steps = lib.dpx_probe_threads(), lib.dpx_probe_steps()
    blocks = n_sm * occ
    dev = torch.device("cuda")
    inp = torch.tensor([y, z, start], dtype=torch.int32, device=dev)
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.dpx_probe_launch(op, inp.data_ptr(), out.data_ptr(),
                                   cycles.data_ptr(), blocks, iters, stream)
        if err:
            raise RuntimeError(f"probe launch failed with CUDA error {err}")
    launch()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    launch()
    ev[1].record()
    torch.cuda.synchronize()
    seconds = ev[0].elapsed_time(ev[1]) / 1e3
    clocks = int(cycles.max())
    total = blocks * threads * iters * steps
    per_clock = total / (n_sm * clocks)
    return {"op": name, "blocks_per_sm": occ, "sms": n_sm,
            "per_clock": per_clock, "per_s": total / seconds,
            "sm_clock_ghz": clocks / seconds / 1e9,
            "triples_per_clock": per_clock * _TRIPLES[op]}


def hops_bound_ms(m: int, n: int, k: int, triples_per_clock: float) -> tuple:
    """(least ms, "bytes" or "operations") of one ``minplus_hops`` product:
    at, b read once and C written once (int16) over the memory rate,
    against ``m n k`` triples at ``triples_per_clock`` on each of the
    card's 132 SMs at the 1.98 GHz boost clock."""
    t_bytes = 2 * (k * m + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    t_ops = m * n * k / (triples_per_clock * N_SM * BOOST_HZ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp32_bound_ms(m: int, n: int, k: int) -> float:
    """The float32 kernel's operations bound for the same product: an add
    and a min per triple at 67 TFLOP/s."""
    return 2 * m * n * k / FP32_OPS_PER_S * 1e3


def cases() -> list:
    """``[(M, K, N, "no path" share)]``: ragged and odd shapes, a 1 x 1 x 1
    product, every share, and the Figure-5 size N = 921 last."""
    return [(37, 53, 29, 0.0), (37, 53, 29, 0.5), (37, 53, 29, 0.9),
            (130, 17, 257, 0.2), (1, 1, 1, 0.0), (64, 40, 48, 1.0),
            (129, 131, 127, 0.5), (300, 65, 9, 0.9), (921, 921, 921, 0.5)]


def _operands(rng, m, k, n, share, device):
    """Seeded hop counts below ``HOPS_LIMIT``, a ``share`` of them
    ``HOPS_INF``, as padded int16 ``at`` [K, M] and ``b`` [K, N]."""
    out = []
    for rows, cols in ((k, m), (k, n)):
        x = rng.integers(0, HOPS_LIMIT, (rows, cols))
        x[rng.random((rows, cols)) < share] = HOPS_INF
        t = padded_hops(rows, cols, device=device)
        t.copy_(torch.as_tensor(x.astype(np.int16)))
        out.append(t)
    return out


def run_cases(seed: int = 300) -> float:
    """Every case of :func:`cases` through the kernel and the plain version
    on the card, bitwise; the output is a view inside a larger buffer
    whose other entries must stay as they were.  Raises on a difference;
    returns the largest absolute difference (0)."""
    dev = torch.device("cuda")
    worst = 0
    for i, (m, k, n, share) in enumerate(cases()):
        at, b = _operands(np.random.default_rng(seed + i), m, k, n, share,
                          dev)
        ld = -(-n // 8) * 8
        base = torch.full((m + 2, ld + 8), -7, dtype=torch.int16, device=dev)
        out = base[1:m + 1, :n]
        got = kernel.minplus_hops(at, b, out)
        want = minplus_hops_ref(at, b)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        same = torch.equal(got, want)
        untouched = int((base == -7).sum()) == base.numel() - m * n
        print(f"minplus_hops [{k},{m}]^T x [{k},{n}] share {share}: "
              f"max_abs_err {err}, bitwise "
              f"{'equal' if same else 'DIFFERENT'}, outside the output "
              f"{'untouched' if untouched else 'WRITTEN'}", flush=True)
        if not (same and untouched):
            raise AssertionError(f"minplus_hops differs from its plain "
                                 f"version at [{k},{m}]^T x [{k},{n}]")
        worst = max(worst, err)
    return worst


def _sass(path) -> Optional[str]:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        return None
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


# one SASS instruction: its address comment, a predicate, the mnemonic
_INSN = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def sass_counts(path) -> Optional[dict]:
    """``{function: {"VIADDMNMX": n, "other_per_viaddmnmx": x, "total": n,
    "top": [[mnemonic, n], ...], "loop_other_per_viaddmnmx": x,
    "loop_top": [...]}}`` for ``minplus_hops_kernel`` and the probe
    kernels of the library at ``path`` (``cuobjdump -sass``); None
    without ``cuobjdump``.  Counts are static: over the whole function,
    and over its inner loop, taken as the instructions from its first
    ``VIADDMNMX`` to its last (the unrolled slab loop)."""
    sass = _sass(path)
    if sass is None:
        return None
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        head = func.split("\n", 1)[0]
        if "minplus_hops_kernel" in head:
            label = "minplus_hops_kernel"
        elif "dpx_probe_kernel" in head:
            op = re.search(r"dpx_probe_kernelILi(\d)E", head)
            label = f"dpx_probe_kernel<{op.group(1) if op else '?'}>"
        else:
            continue
        insns = _INSN.findall(func)
        ops = collections.Counter(insns)
        total = sum(ops.values())
        dpx = ops.get("VIADDMNMX", 0)
        at = [i for i, op in enumerate(insns) if op == "VIADDMNMX"]
        loop = collections.Counter(insns[at[0]:at[-1] + 1] if at else ())
        out[label] = {"VIADDMNMX": dpx, "total": total,
                      "other_per_viaddmnmx": ((total - dpx) / dpx
                                              if dpx else None),
                      "top": ops.most_common(8),
                      "loop_other_per_viaddmnmx": (
                          (sum(loop.values()) - dpx) / dpx if dpx else None),
                      "loop_top": loop.most_common(8)}
    return out


def time_921(triples_per_clock: float) -> dict:
    """Kernel (its C entry point, back to back) and plain version at
    N = 921, with both bounds."""
    dev = torch.device("cuda")
    n = 921
    at, b = _operands(np.random.default_rng(0), n, n, n, 0.5, dev)
    c = padded_hops(n, n, device=dev)
    lib = kernel._lib()
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: lib.minplus_hops_launch(
        at.data_ptr(), b.data_ptr(), c.data_ptr(), n, n, n, at.stride(0),
        b.stride(0), c.stride(0), stream), iters=50, warmup=5)
    plain = cuda_ms(lambda: minplus_hops_ref(at, b), iters=5, warmup=1)
    bnd, by = hops_bound_ms(n, n, n, triples_per_clock)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "fp32_bound_ms": fp32_bound_ms(n, n, n)}


def time_fig6(triples_per_clock: float, iters: int = 3) -> dict:
    """Per-launch ms of the two products of a squaring at each Figure-6
    build's shapes (random hop counts: the kernel's time does not depend
    on the values), with both bounds."""
    dev = torch.device("cuda")
    out = {}
    for label, (n, n1) in FIG6.items():
        split = min(-(-n1 // 8) * 8, n)
        d = padded_hops(n, n, device=dev)
        d.copy_(torch.randint(0, 8, (n, n), dtype=torch.int16, device=dev))
        nd = padded_hops(n, n, device=dev)
        for part, (lo, hi) in (("leaf rows", (0, split)),
                               ("other rows", (split, n))):
            m = hi - lo
            ms = cuda_ms(lambda: kernel.minplus_hops(d[:, lo:hi], d,
                                                     nd[lo:hi]),
                         iters=iters, warmup=1)
            bnd, by = hops_bound_ms(m, n, n, triples_per_clock)
            out[f"{label} {part}"] = {
                "m": m, "n": n, "k": n, "ms": ms, "bound_ms": bnd,
                "bound_by": by, "fp32_bound_ms": fp32_bound_ms(m, n, n)}
            print(f"minplus_hops {label} {part} [{n},{m}]^T x [{n},{n}]: "
                  f"{ms:.6f} ms per launch, bound {bnd:.6f} ms ({by}, "
                  f"{100 * bnd / ms:.1f}% of it); float32 kernel's bound "
                  f"{fp32_bound_ms(m, n, n):.6f} ms", flush=True)
        del d, nd
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("minplus bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip() or 'not available'}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    rec = _build.build_all(["minplus"])["minplus"]
    print(f"built {rec['path'].name} in {time.perf_counter() - t0:.2f} s")
    print(rec["log"].strip())
    counts = sass_counts(rec["path"])
    print(f"SASS: {json.dumps(counts)}")
    rates = {}
    for op in _PROBE:
        rates[op] = probe(op)
        print(f"probe {json.dumps(rates[op])}", flush=True)
    tpc = rates[0]["triples_per_clock"]
    if rates[1]["triples_per_clock"] > tpc:
        print("note: __viaddmin_s32 gives more triples per clock than "
              "__viaddmin_s16x2")
    try:
        err = run_cases()
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    n921 = time_921(tpc)
    print(f"minplus_hops N=921: kernel {n921['ms']:.6f} ms per launch, "
          f"bound {n921['bound_ms']:.6f} ms ({n921['bound_by']}), plain "
          f"{n921['plain_ms']:.6f} ms; float32 kernel's bound "
          f"{n921['fp32_bound_ms']:.6f} ms", flush=True)
    fig6 = time_fig6(tpc)
    print(json.dumps({"probe": rates, "max_abs_err": err, "n921": n921,
                      "fig6": fig6, "sass": counts}))
    hops = (counts or {}).get("minplus_hops_kernel", {})
    return 0 if hops.get("VIADDMNMX") else 1


if __name__ == "__main__":
    sys.exit(main())
