#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — compile every CUDA kernel of the port from ``src/`` with
   ``nvcc`` (build seconds and the ``-Xptxas -v`` report);
3. kernels  — each kernel against its plain PyTorch version on the card,
   bitwise, on seeded inputs at the paper's 11k-endpoint shapes and at
   two ragged shapes; kernel time, plain time and the bound, timed with
   CUDA events;
4. golden   — the polarized, minimal_adaptive and ksp entries of
   ``tests/golden/engine_parity.json`` reproduce exactly on the card;
5. full width — the paper's Figure-5 MRLS (11,052 endpoints, Polarized,
   uniform load 1.0, 300 + 300 slots) through ``repro_torch.api.run``
   equals ``tests/golden/torch_fig5_mrls_u18.json`` field for field, and
   every kernel of the path launched the expected number of times;
6. breakdown — where a slot of that fabric spends its time: per-phase
   CUDA-event times, the PRNG draws alone, and the device-busy share
   from ``torch.profiler``; and two slots under
   ``torch.cuda.set_sync_debug_mode("error")`` to show that the step
   never synchronises with the host.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/`` beside it, the script exits with code 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ENGINE_GOLDEN = ROOT / "tests" / "golden" / "engine_parity.json"
FIG5_GOLDEN = ROOT / "tests" / "golden" / "torch_fig5_mrls_u18.json"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu"
REPLACES = {
    "vc_prearb": "src/repro/kernels/switch_arb/kernel.py:64",
    "switch_arbitrate": "src/repro/kernels/switch_arb/kernel.py:113",
}


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back calls."""
    import torch
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


def bound_ms(n_bytes: int, fp32_ops: int) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
def run_device():
    import torch
    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; {torch.cuda.device_count()} device(s)")
    return name, smi.splitlines()[0]


def run_build():
    from repro_torch.kernels import _build
    phase("2. build")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"built {sorted(info)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, rec in sorted(info.items()):
        print(f"--- {name}: {rec['path'].name} ({rec['seconds']:.2f} s)")
        print(rec["log"].strip())


def _arb_inputs(rng, n, r, p, device):
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(a, device=device)
    return (t(rng.integers(0, 12, (n, r, p), dtype=np.int32)),
            t(rng.integers(0, 2, (n, r, p), dtype=np.int32)),
            t(rng.integers(0, 2, (n, r, p), dtype=np.int32)),
            t(rng.random((n, r, p), dtype=np.float32)),
            t(rng.integers(0, 2, (n, r), dtype=np.int32)),
            t(rng.integers(0, 256, (n, r), dtype=np.int32)),
            t(np.arange(n * r, dtype=np.int32).reshape(n, r)))


def _vc_inputs(rng, n, p, v, device):
    import numpy as np
    import torch
    return (torch.as_tensor(rng.integers(0, 3, (n, p, v), dtype=np.int32),
                            device=device),
            torch.as_tensor(rng.random((n, p, v), dtype=np.float32),
                            device=device))


def _max_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def run_kernels(shapes):
    """Bitwise kernel-vs-plain checks and timings; returns the records."""
    import numpy as np
    import torch
    from repro_torch.kernels.switch_arb import kernel, ref
    phase("3. kernels vs plain, on the card")
    dev = torch.device("cuda")
    n, p, v, r = shapes["N"], shapes["P"], shapes["V"], shapes["R"]
    pen = 8.0
    records = {}

    vc_cases = [(n, p, v), (5, 7, 3), (9, 16, 8)]
    for i, (a, b, c) in enumerate(vc_cases):
        args = _vc_inputs(np.random.default_rng(100 + i), a, b, c, dev)
        got, want = kernel.vc_prearb(*args), ref.vc_prearb_ref(*args)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        print(f"vc_prearb [{a},{b},{c}]: max_abs_err {err}")
        if err:
            raise AssertionError(f"vc_prearb differs from its plain version "
                                 f"at [{a},{b},{c}]")
        if i == 0:
            # the kernel alone: its C entry point launched back to back on
            # preallocated outputs; the wrapper adds its checks and
            # allocations on the host
            outs = [torch.empty((a, b), dtype=torch.int32, device=dev)
                    for _ in range(2)]
            ptrs = [t.data_ptr() for t in (*args, *outs)]
            stream = torch.cuda.current_stream().cuda_stream
            lib = kernel._lib()
            ms = cuda_ms(lambda: lib.vc_prearb_launch(*ptrs, a * b, c,
                                                      stream))
            call = cuda_ms(lambda: kernel.vc_prearb(*args))
            plain = cuda_ms(lambda: ref.vc_prearb_ref(*args))
            bnd, by = bound_ms(a * b * c * 8 + a * b * 8, a * b * c * 2)
            records["vc_prearb"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain, bound_ms=bnd,
                                        bound_by=by)
            print(f"  [{a},{b},{c}] kernel {ms:.6f} ms (wrapper call "
                  f"{call:.6f} ms), plain {plain:.6f} ms, bound {bnd:.6f} "
                  f"ms ({by})")

    arb_cases = [(n, r, p), (5, 9, 7), (3, 300, 290)]
    for i, (a, b, c) in enumerate(arb_cases):
        args = _arb_inputs(np.random.default_rng(200 + i), a, b, c, dev)
        got = kernel.switch_arbitrate(*args, penalty=pen)
        want = ref.switch_arbitrate_ref(*args, penalty=pen)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        print(f"switch_arbitrate [{a},{b},{c}]: max_abs_err {err}")
        if err:
            raise AssertionError(f"switch_arbitrate differs from its plain "
                                 f"version at [{a},{b},{c}]")
        if i == 0:
            outs = [torch.empty(shape, dtype=torch.int32, device=dev)
                    for shape in ((a, b), (a, b), (a, c))]
            ptrs = [t.data_ptr() for t in (*args, *outs)]
            stream = torch.cuda.current_stream().cuda_stream
            lib = kernel._lib()
            ms = cuda_ms(lambda: lib.switch_arbitrate_launch(
                *ptrs, a, b, c, pen, stream))
            call = cuda_ms(lambda: kernel.switch_arbitrate(*args,
                                                           penalty=pen))
            plain = cuda_ms(
                lambda: ref.switch_arbitrate_ref(*args, penalty=pen))
            n_bytes = a * b * c * 16 + a * b * 12 + a * b * 8 + a * c * 4
            bnd, by = bound_ms(n_bytes, a * b * c * 4)
            records["switch_arbitrate"] = dict(max_abs_err=err, ms=ms,
                                               plain_ms=plain, bound_ms=bnd,
                                               bound_by=by)
            print(f"  [{a},{b},{c}] kernel {ms:.6f} ms (wrapper call "
                  f"{call:.6f} ms), plain {plain:.6f} ms, bound {bnd:.6f} "
                  f"ms ({by}, {n_bytes} bytes)")
    return records


def run_golden():
    import numpy as np
    from repro_torch.core import build_tables, mrls
    from repro_torch.simulator.engine import SimConfig, Simulator, Traffic
    phase("4. golden replay on the card")
    g = json.loads(ENGINE_GOLDEN.read_text())
    tables = build_tables(mrls(**g["fabric"]))
    for policy in ("polarized", "minimal_adaptive", "ksp"):
        gp = g["policies"][policy]
        # the golden was captured with jax's original threefry stream
        sim = Simulator(tables, SimConfig(policy=policy, max_hops=10,
                                          pool=4096,
                                          threefry_partitionable=False),
                        device="cuda")
        thr = sim.run_throughput(Traffic("uniform", load=0.7),
                                 warm=g["warm"], measure=g["measure"])
        lat = sim.run_latency(Traffic("uniform", load=0.5),
                              warm=g["warm"], measure=g["measure"])
        hist = {str(i): int(c) for i, c in enumerate(np.asarray(lat["hist"]))
                if c}
        got = (thr["throughput"], thr["avg_hops"], thr["ejected"],
               thr["pool_stall"], hist)
        want = (gp["throughput"], gp["avg_hops"], gp["ejected"],
                gp["pool_stall"], gp["lat_hist_nonzero"])
        print(f"{policy}: throughput {thr['throughput']!r} avg_hops "
              f"{thr['avg_hops']!r} ejected {thr['ejected']} -> "
              f"{'exact' if got == want else 'DIFFERS'}")
        if got != want:
            raise AssertionError(f"golden replay of {policy} differs: "
                                 f"{got} != {want}")


def run_full_width():
    import torch
    from repro_torch.api import Experiment, run
    from repro_torch.kernels.switch_arb import kernel
    phase("5. full width: Figure-5 MRLS through repro_torch.api.run")
    golden = json.loads(FIG5_GOLDEN.read_text())
    exp = Experiment.from_dict(golden["experiment"])
    slots = exp.warm + exp.measure
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(exp, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launch_counts()
    got = res.to_dict()
    print(f"result: throughput {res.throughput!r} avg_hops "
          f"{res.avg_hops!r} ejected {res.ejected} pool_stall "
          f"{res.pool_stall}")
    print(f"run: {slots} slots in {wall:.3f} s end to end (tables, "
          f"simulator set-up and slots) = {slots / wall:.2f} slots/s; "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    if got != golden:
        diff = {k: (got.get(k), golden.get(k)) for k in golden
                if got.get(k) != golden.get(k)}
        raise AssertionError(f"Fig-5 Result differs from the JAX "
                             f"reference: {diff}")
    print("Result equals tests/golden/torch_fig5_mrls_u18.json field for "
          "field")
    # per slot: speedup crossbar rounds each launch both kernels once, and
    # the link phase launches vc_prearb once more
    speedup = exp.route.speedup
    expected = {"vc_prearb": (speedup + 1) * slots,
                "switch_arbitrate": speedup * slots}
    print(f"launches on the main path: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return launches


def run_breakdown(tables, exp) -> dict:
    """Where one slot of the Fig-5 fabric spends its time on the card.
    Returns each kernel's device ms per launch on the main path, from the
    profiler (empty if it saw no device events)."""
    import torch
    from repro_torch import prng
    from repro_torch.simulator.engine import Simulator, Traffic
    phase("6. breakdown of a Fig-5 slot")
    sim = Simulator(tables, exp.route.to_sim_config(), device="cuda")
    tr = Traffic(exp.workload.pattern, load=exp.workload.load)
    st = sim.make_state(tr, seed=exp.seed)
    sim.run_chunk(st, tr, 100)                  # into steady state
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    sim.run_chunk(st, tr, n)
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"steady state: {slot_ms:.4f} ms per slot (host clock, "
          f"{n} slots) = {1e3 / slot_ms:.2f} slots/s")

    names = ["inject"] + [f"crossbar{r}" for r in range(sim.cfg.speedup)] \
        + ["link"]
    acc = dict.fromkeys(names, 0.0)
    n_ev = 20
    for _ in range(n_ev):
        key, k_inj, k_link, *k_xb = prng.split(
            st["key"], 3 + sim.cfg.speedup, partitionable=sim._pt)
        st["key"] = key
        ev = [torch.cuda.Event(enable_timing=True) for _ in names + [0]]
        ev[0].record()
        sim._inject(st, k_inj, tr)
        ev[1].record()
        for r in range(sim.cfg.speedup):
            sim._crossbar_round(st, k_xb[r])
            ev[2 + r].record()
        sim._link_phase(st, k_link)
        ev[-1].record()
        st["slot"] = st["slot"] + 1
        torch.cuda.synchronize()
        for i, nm in enumerate(names):
            acc[nm] += ev[i].elapsed_time(ev[i + 1]) / n_ev
    print("per phase (CUDA events, ms per slot): "
          + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))

    # the slot's PRNG draws alone, at the same shapes
    pt = sim._pt
    N, P, V, S, NR = sim.N, sim.P, sim.V, sim.S, sim.NR
    key = st["key"]

    def draws():
        prng.split(key, 3 + sim.cfg.speedup, partitionable=pt)
        prng.split(key, 4, partitionable=pt)
        prng.uniform(key, (S,), partitionable=pt)
        prng.randint(key, (S,), 0, S, partitionable=pt)
        for _ in range(sim.cfg.speedup):
            prng.split(key, 3, partitionable=pt)
            prng.uniform(key, (N, P, V), partitionable=pt)
            prng.uniform(key, (NR, P), partitionable=pt)
            prng.randint(key, (NR,), 0, 256, partitionable=pt)
        prng.uniform(key, (N * P, V), partitionable=pt)
    prng_ms = cuda_ms(draws, iters=20, warmup=3)
    print(f"PRNG draws of one slot alone: {prng_ms:.4f} ms "
          f"({100 * prng_ms / slot_ms:.1f}% of the steady slot)")

    # the step must never wait for the device: any synchronising call
    # (.item(), nonzero, a boolean-mask index) raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.run_chunk(st, tr, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("2 slots under torch.cuda.set_sync_debug_mode('error'): the step "
          "makes no host synchronisation")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_chunk(st, tr, n_prof)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    # device-side events only (kernels, copies, sets): the CPU-side aten
    # rows carry their kernels' time too and would count it twice
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.count,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / n_prof / 1e3
    if busy_ms <= 0:
        print("profiler: device time not measured (no device events)")
        return {}
    launches = sum(r[1] for r in rows) / n_prof
    print(f"profiler, {n_prof} slots: device busy {busy_ms:.4f} ms per "
          f"slot in {launches:.0f} device operations; profiled slot "
          f"{wall_ms:.4f} ms; idle share {100 * (1 - busy_ms / slot_ms):.1f}"
          f"% of the unprofiled {slot_ms:.4f} ms slot")
    per_launch = {}
    for dev_us, count, k in rows:
        for nm in REPLACES:
            if f"{nm}_kernel" in k:
                per_launch[nm] = dev_us / count / 1e3
                print(f"  {nm}: {dev_us / count:.3f} us per launch on the "
                      f"main path ({count} launches)")
    for dev_us, count, k in rows[:10]:
        print(f"  {dev_us / n_prof / 1e3:8.4f} ms/slot {count // n_prof:6d}"
              f"x/slot  {k[:80]}")
    return per_launch


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    name, smi = run_device()
    run_build()

    from repro_torch.api import Experiment, build_network
    from repro_torch.core import build_tables
    from repro_torch.simulator.engine import Simulator, SimConfig
    exp = Experiment.from_dict(json.loads(FIG5_GOLDEN.read_text())
                               ["experiment"])
    tables = build_tables(build_network(exp.network))
    geo = Simulator(tables, SimConfig(), device="cuda")
    shapes = {"N": geo.N, "P": geo.P, "V": geo.V, "R": geo.R_max}
    del geo
    print(f"Fig-5 shapes: {shapes}")

    records = run_kernels(shapes)
    run_golden()
    launches = run_full_width()
    per_launch = run_breakdown(tables, exp)

    # a kernel's time is its device time per launch on the main path where
    # the profiler saw it; else the back-to-back launch time of phase 3
    # (an upper bound: Python launches no faster than a few microseconds)
    for k in records:
        records[k]["launches"] = launches[k]
        records[k]["ms"] = per_launch.get(k, records[k]["ms"])
    out = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[k], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None}
           for k, rec in records.items()]
    print("\nkernels: " + "; ".join(
        f"{r['name']} launches {r['launches']} bitwise "
        f"{'ok' if r['max_abs_err'] == 0 else 'FAILED'} {r['ms']:.6f} ms "
        f"(bound {r['bound_ms']:.6f} ms)" for r in out))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
