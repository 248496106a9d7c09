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
   ragged shapes (``minplus`` also with ``INF`` entries, on the Figure-5
   adjacency, and on the adjacency of both 104,976-endpoint fabrics
   squared to the fixpoint through the wrapper, each squaring's first,
   middle and last row blocks held against the plain version); kernel
   time, plain time and the bound, timed with CUDA events;
4. golden   — the polarized, minimal_adaptive and ksp entries of
   ``tests/golden/engine_parity.json`` reproduce exactly on the card;
5. full width — the paper's Figure-5 MRLS (11,052 endpoints, Polarized,
   uniform load 1.0, 300 + 300 slots) through ``repro_torch.api.run``
   (tables on the card included) equals
   ``tests/golden/torch_fig5_mrls_u18.json`` field for field, and every
   kernel of the path launched the expected number of times;
6. breakdown — where a slot of that fabric spends its time: per-phase
   CUDA-event times, the slot's PRNG draws alone in the same event
   window, and the device-busy share from ``torch.profiler``; and two
   slots under ``torch.cuda.set_sync_debug_mode("error")`` to show that
   the step never synchronises with the host;
7. tables   — the routing tables of the three All2All fabrics built on
   the card (``minplus`` squarings, mask packing, simulator set-up);
   for both 104,976-endpoint Figure-6 fabrics the card's distances
   equal the host BFS, and for the Figure-6 MRLS its mask words equal
   the host's numpy packing of the first, middle and last leaf blocks,
   each host step timed;
8. all2all  — the Figure-5 MRLS and both Figure-6 fabrics (MRLS f1 and
   the 50 %-depopulated Fat-Tree, 104,976 endpoints each) run an
   All2All of 16 rounds to completion through ``repro_torch.api.run``;
   each Result equals its ``tests/golden/torch_a2a_*.json`` field for
   field, and every kernel launched the expected number of times.

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
# the All2All points of phases 7 and 8, smallest first
A2A_GOLDENS = {
    label: ROOT / "tests" / "golden" / f"torch_a2a_{name}.json"
    for label, name in (("fig5.mrls_u18", "fig5_mrls_u18"),
                        ("fig6.mrls_f1", "fig6_mrls_f1"),
                        ("fig6.ft50", "fig6_ft50"))}

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "vc_prearb": ("src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu",
                  "src/repro/kernels/switch_arb/kernel.py:64"),
    "switch_arbitrate": (
        "src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu",
        "src/repro/kernels/switch_arb/kernel.py:113"),
    "minplus": ("src/repro_torch/kernels/minplus/csrc/minplus.cu",
                "src/repro/kernels/minplus/kernel.py:42"),
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


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.switch_arb import kernel as arb
    arb.reset_launch_counts()
    mp.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since the last :func:`reset_counts`."""
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.switch_arb import kernel as arb
    return {**arb.launch_counts(), **mp.launch_counts()}


def check_counts(counts: dict, expected: dict, path: str) -> None:
    print(f"launches on {path}: {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"kernel launches on {path}: {counts} != "
                             f"{expected}")


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


def run_minplus(fig5_nbrs, fabrics: dict) -> dict:
    """Bitwise checks of ``minplus`` and its timings; returns its record
    (times at the Figure-5 size, where the plain version is timed).

    ``fabrics`` maps a label to the neighbour array of each 100k fabric:
    its adjacency is squared to the fixpoint through the wrapper, as the
    table build squares it, each launch timed with CUDA events and its
    first, middle and last row blocks held against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.minplus import kernel, ref
    dev = torch.device("cuda")

    def check(label, a, b):
        got, want = kernel.minplus(a, b), ref.minplus_ref(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        same = torch.equal(got, want)
        print(f"minplus {label}: max_abs_err {err!r}, bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"minplus differs from its plain version "
                                 f"at {label}")
        return err, want

    # seeded operands, a share of them INF, at ragged shapes and at N = 921
    errs = []
    cases = [(37, 53, 29, 0.0), (37, 53, 29, 0.9), (130, 17, 257, 0.2),
             (1, 1, 1, 0.0), (64, 40, 48, 1.0), (921, 921, 921, 0.5)]
    for i, (m, k, n, frac) in enumerate(cases):
        rng = np.random.default_rng(300 + i)
        a = rng.uniform(0, 10, (m, k)).astype(np.float32)
        b = rng.uniform(0, 10, (k, n)).astype(np.float32)
        a[rng.random((m, k)) < frac] = ref.INF
        b[rng.random((k, n)) < frac] = ref.INF
        errs.append(check(f"[{m},{k}]x[{k},{n}] INF share {frac}",
                          torch.as_tensor(a, device=dev),
                          torch.as_tensor(b, device=dev))[0])
    # the Figure-5 adjacency (N = 921) squared three times, as the table
    # build squares it
    d = ref.adjacency_matrix(fig5_nbrs, device=dev)
    for i in range(3):
        err, d = check(f"Figure-5 adjacency, squaring {i + 1}", d, d)
        errs.append(err)

    stream = torch.cuda.current_stream().cuda_stream
    lib = kernel._lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 921
    x = torch.rand((n, n), generator=gen, device=dev) * 10
    c = torch.empty_like(x)
    ms = cuda_ms(lambda: lib.minplus_launch(
        x.data_ptr(), x.data_ptr(), c.data_ptr(), n, n, n, stream), iters=50,
        warmup=5)
    plain = cuda_ms(lambda: ref.minplus_ref(x, x), iters=5, warmup=1)
    bnd, by = bound_ms(4 * 3 * n * n, 2 * n ** 3)
    record = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    print(f"minplus N={n}: kernel {ms:.6f} ms per launch (50 launches), "
          f"bound {bnd:.6f} ms ({by}), {100 * bnd / ms:.1f}% of the bound; "
          f"plain {plain:.6f} ms")
    del x, c

    for label, nbrs in fabrics.items():
        d = ref.adjacency_matrix(nbrs, device=dev)
        n = d.shape[0]
        blk = 128
        rows = sorted({0, (n // 2) // blk * blk, n - blk})
        launch_ms = []
        for i in range(16):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            nd = kernel.minplus(d, d)
            ev[1].record()
            torch.cuda.synchronize()
            launch_ms.append(ev[0].elapsed_time(ev[1]))
            for lo in rows:
                want = ref.minplus_ref(d[lo:lo + blk], d)
                if not torch.equal(nd[lo:lo + blk], want):
                    raise AssertionError(
                        f"minplus differs from its plain version on {label}"
                        f", squaring {i + 1}, rows {lo}:{lo + blk}")
                errs.append(float((nd[lo:lo + blk] - want).abs().max()))
            done = torch.equal(nd, d)
            d = nd
            if done:
                break
        del d, nd
        torch.cuda.empty_cache()
        ms = sum(launch_ms) / len(launch_ms)
        bnd, by = bound_ms(4 * 3 * n * n, 2 * n ** 3)
        print(f"minplus {label} N={n}: {len(launch_ms)} squarings to the "
              f"fixpoint through the wrapper, each bitwise equal to the "
              f"plain version on rows {[(r, r + blk) for r in rows]}; "
              f"{ms:.6f} ms per launch (CUDA events: "
              f"{[round(t, 3) for t in launch_ms]}), bound {bnd:.6f} ms "
              f"({by}), {100 * bnd / ms:.1f}% of the bound")
    return dict(max_abs_err=max(errs), **record)


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


def run_full_width(squarings: int) -> dict:
    import torch
    from repro_torch.api import Experiment, run
    phase("5. full width: Figure-5 MRLS through repro_torch.api.run")
    golden = json.loads(FIG5_GOLDEN.read_text())
    exp = Experiment.from_dict(golden["experiment"])
    slots = exp.warm + exp.measure
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run(exp, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
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
    # the link phase launches vc_prearb once more; the table build squares
    # the adjacency matrix once per minplus launch
    check_counts(launches, expected_counts(exp, slots, squarings),
                 "the Figure-5 uniform run")
    return launches


def expected_counts(exp, slots: int, squarings: int) -> dict:
    speedup = exp.route.speedup
    return {"vc_prearb": (speedup + 1) * slots,
            "switch_arbitrate": speedup * slots, "minplus": squarings}


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

    # the slot's PRNG draws, again and alone at the same shapes, timed in
    # the same CUDA-event window as the phases that make them
    pt = sim._pt
    N, P, V, S, NR = sim.N, sim.P, sim.V, sim.S, sim.NR

    def draws(key):
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

    names = ["inject"] + [f"crossbar{r}" for r in range(sim.cfg.speedup)] \
        + ["link", "prng"]
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
        ev[-2].record()
        draws(key)
        ev[-1].record()
        st["slot"] = st["slot"] + 1
        torch.cuda.synchronize()
        for i, nm in enumerate(names):
            acc[nm] += ev[i].elapsed_time(ev[i + 1]) / n_ev
    prng_ms = acc.pop("prng")
    phases_ms = sum(acc.values())
    print("per phase (CUDA events, ms per slot): "
          + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
          + f"; sum {phases_ms:.4f}")
    print(f"PRNG draws of one slot alone, in the same window: {prng_ms:.4f} "
          f"ms ({100 * prng_ms / phases_ms:.1f}% of the phases' sum)")

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
        for nm in KERNELS:
            if f"{nm}_kernel" in k:
                per_launch[nm] = dev_us / count / 1e3
                print(f"  {nm}: {dev_us / count:.3f} us per launch on the "
                      f"main path ({count} launches)")
    for dev_us, count, k in rows[:10]:
        print(f"  {dev_us / n_prof / 1e3:8.4f} ms/slot {count // n_prof:6d}"
              f"x/slot  {k[:80]}")
    return per_launch


def run_tables(points: dict) -> dict:
    """Routing tables of each All2All fabric built on the card, timed;
    the Figure-6 fabrics' distances against the host BFS, and the
    Figure-6 MRLS's mask words against the host packing.  Returns each
    point's minplus squarings."""
    import numpy as np
    import torch
    from repro_torch.api import build_network
    from repro_torch.core import bfs_distances, build_tables
    from repro_torch.core.routing import _pack_mask_block
    from repro_torch.simulator.engine import Simulator
    phase("7. routing tables on the card")
    squarings = {}
    for label, exp in points.items():
        t0 = time.perf_counter()
        topo = build_network(exp.network)
        t_topo = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = build_tables(topo, device="cuda")
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
        sim = Simulator(tables, exp.route.to_sim_config(), device="cuda")
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0 - t_tab
        check_counts(read_counts(), {"vc_prearb": 0, "switch_arbitrate": 0,
                                     "minplus": tables.squarings},
                     f"the {label} table build")
        squarings[label] = tables.squarings
        t0 = time.perf_counter()
        sim._build_device_masks(tables)
        torch.cuda.synchronize()
        t_masks = time.perf_counter() - t0
        print(f"{label}: N={topo.n_switches} switches, N1={topo.n_leaves} "
              f"leaves, {topo.n_endpoints} endpoints, P={topo.max_ports}; "
              f"topology {t_topo:.3f} s on the host; set-up on the card "
              f"{t_tab + t_sim:.3f} s = tables {t_tab:.3f} s "
              f"({tables.squarings} minplus squarings and the int16 leaf "
              f"rows) + Simulator.__init__ {t_sim:.3f} s; the device mask "
              f"packing alone, run again: {t_masks:.3f} s for "
              f"{-(-topo.n_leaves // tables.leaf_block)} leaf blocks")
        if label.startswith("fig6."):
            t0 = time.perf_counter()
            bfs = bfs_distances(topo, topo.leaf_ids)
            t_bfs = time.perf_counter() - t0
            same = np.array_equal(bfs, tables.dist_leaf.cpu().numpy())
            print(f"{label}: host BFS of the leaf rows {t_bfs:.3f} s; the "
                  f"card's dist_leaf {'equals' if same else 'DIFFERS FROM'}"
                  " it element for element")
            if not same:
                raise AssertionError(f"dist_leaf from minplus differs from "
                                     f"the BFS on {label}")
        if label == "fig6.mrls_f1":
            nbrs = topo.nbrs
            valid = nbrs >= 0
            nbr_safe = np.where(valid, nbrs, 0)
            n, w, blk = sim.N, sim.W, tables.leaf_block
            n_blocks = -(-topo.n_leaves // blk)
            checked = sorted({0, n_blocks // 2, n_blocks - 1})
            host_s = []
            for b in checked:
                lo, hi = b * blk, min((b + 1) * blk, topo.n_leaves)
                t0 = time.perf_counter()
                min_b, away_b = _pack_mask_block(bfs[lo:hi], nbrs, valid,
                                                 nbr_safe)
                host_s.append(time.perf_counter() - t0)
                for name, host, dev_t in (("min", min_b, sim.min_mask),
                                          ("away", away_b, sim.away_mask)):
                    got = dev_t[lo * n:hi * n].cpu().numpy()
                    if not np.array_equal(
                            got, host.reshape(-1, w).view(np.int32)):
                        raise AssertionError(f"{name} mask words of leaf "
                                             f"block {b} differ")
            print(f"{label}: device mask words equal the host's numpy "
                  f"packing in leaf blocks {checked} of {n_blocks}; host "
                  "seconds per block "
                  f"{[round(x, 3) for x in host_s]} (mean "
                  f"{sum(host_s) / len(host_s):.3f} s, so about "
                  f"{n_blocks * sum(host_s) / len(host_s):.1f} s for all "
                  f"{n_blocks})")
        del sim, tables
        torch.cuda.empty_cache()
    return squarings


def run_all2all(points: dict, squarings: dict) -> dict:
    """Each All2All point through ``repro_torch.api.run`` on the card,
    against its golden; returns the launches summed over the points."""
    import torch
    from repro_torch.api import run
    from repro_torch.simulator.engine import Simulator
    phase("8. All2All to completion through repro_torch.api.run")
    # the slots actually run and their time, read around the user's call
    # without changing it
    timing = {}
    run_completion = Simulator.run_completion

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_completion(self, *args, **kw)
        torch.cuda.synchronize()
        timing["run_s"] = time.perf_counter() - t0
        timing["slots_run"] = int(r["state"]["slot"])
        return r

    total = dict.fromkeys(KERNELS, 0)
    slots = {}
    Simulator.run_completion = timed
    try:
        for label, exp in points.items():
            golden = json.loads(A2A_GOLDENS[label].read_text())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = run(exp, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            ran, run_s = timing.pop("slots_run"), timing.pop("run_s")
            print(f"{label}: completion at slot {res.slots} "
                  f"(completed {res.completed}, pool_stall "
                  f"{res.pool_stall}); {ran} slots run (chunk "
                  f"{exp.chunk}); {wall:.3f} s end to end = set-up "
                  f"{wall - run_s:.3f} s + run {run_s:.3f} s "
                  f"({ran / run_s:.2f} slots/s); peak device memory "
                  f"{torch.cuda.max_memory_allocated()} bytes")
            if res.to_dict() != golden:
                got = res.to_dict()
                diff = {k: (got.get(k), golden.get(k)) for k in golden
                        if got.get(k) != golden.get(k)}
                raise AssertionError(f"{label} Result differs from the JAX "
                                     f"reference: {diff}")
            print(f"{label}: Result equals {A2A_GOLDENS[label].name} field "
                  "for field")
            check_counts(counts, expected_counts(exp, ran, squarings[label]),
                         f"the {label} All2All run")
            for k in total:
                total[k] += counts[k]
            slots[label] = res.slots
    finally:
        Simulator.run_completion = run_completion
    print(f"Fat-Tree / MRLS completion slots at 104,976 endpoints: "
          f"{slots['fig6.ft50']} / {slots['fig6.mrls_f1']} = "
          f"{slots['fig6.ft50'] / slots['fig6.mrls_f1']:.4f} (simulated "
          "slots, a simulation output)")
    return total


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
    tables = build_tables(build_network(exp.network), device="cuda")
    geo = Simulator(tables, SimConfig(), device="cuda")
    shapes = {"N": geo.N, "P": geo.P, "V": geo.V, "R": geo.R_max}
    del geo
    print(f"Fig-5 shapes: {shapes}; {tables.squarings} minplus squarings "
          "build its tables")

    points = {label: Experiment.from_dict(json.loads(path.read_text())
                                          ["experiment"])
              for label, path in A2A_GOLDENS.items()}
    records = run_kernels(shapes)
    records["minplus"] = run_minplus(
        tables.topo.nbrs, {label: build_network(p.network).nbrs
                           for label, p in points.items()
                           if label.startswith("fig6.")})
    run_golden()
    launches = run_full_width(tables.squarings)
    per_launch = run_breakdown(tables, exp)
    del tables
    squarings = run_tables(points)
    for k, n in run_all2all(points, squarings).items():
        launches[k] += n

    # a kernel's time is its device time per launch on the main path where
    # the profiler saw it; else the back-to-back launch time of phase 3
    # (an upper bound: Python launches no faster than a few microseconds).
    # Launches are summed over the main-path runs of phases 5 and 8.
    for k in records:
        records[k]["launches"] = launches[k]
        records[k]["ms"] = per_launch.get(k, records[k]["ms"])
    out = [{"name": k, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1], "launches": rec["launches"],
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
