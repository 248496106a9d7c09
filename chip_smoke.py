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
   ragged shapes: the crossbar kernels through
   ``kernels/switch_arb/bench.py`` (``switch_arbitrate_rows`` with each
   number of lanes a row on seeded queue states of the golden fabric,
   the Figure-5 MRLS, the Figure-6 Fat-Tree and Figure 7's Dragonfly
   (P = 23) and Dragonfly+ (P = 32, d = 16) under the three policies'
   settings; the dense ``switch_arbitrate``; ``vc_prearb`` with and
   without its head-packet gather, at the Figure-5 and Figure-7
   shapes), with the shared bytes a block, their SASS counts, times
   beside an empty kernel's and bounds (``minplus`` also with ``INF``
   entries, on the Figure-5 adjacency, and on the adjacency of both
   104,976-endpoint fabrics squared to the fixpoint through the wrapper,
   each squaring's first, middle and last row blocks held against the
   plain version); kernel
   time, plain time and the bound, timed with CUDA events.  The int16
   ``minplus_hops``: the DPX issue rate that sets its bound
   (``kernels/minplus/bench.py``'s probe), its ``VIADDMNMX`` count, the
   bench's ragged and odd cases at "no path" shares 0 to 1 and N = 921,
   and every product of the Figure-5, both Figure-6 and the three
   Figure-7 table builds (``core.routing.hop_distances``), each timed
   and its first, middle and last row blocks held bitwise against the
   plain version;
4. golden   — all five policies of
   ``tests/golden/torch_engine_parity_short.json`` (polarized,
   minimal_adaptive, ksp, ugal, valiant: ``engine_parity.json``'s
   fabric, loads and ``SimConfig`` at 20 + 40 slots, jax's original
   threefry stream) reproduce exactly on the card, on tables built
   there (``tests/test_torch_golden.py`` replays the full-length golden
   through the port on the CPU);
5. (none: Figure 5's scalar uniform run moved into phase 15, whose
   4-replica run holds replica 0 against
   ``tests/golden/torch_fig5_mrls_u18.json``);
6. breakdown — where a slot of the Figure-5 MRLS (11,052 endpoints,
   Polarized, uniform load 1.0) spends its time: per-phase
   CUDA-event times, the slot's PRNG draws alone in the same event
   window, and the device-busy share from ``torch.profiler``; and two
   slots under ``torch.cuda.set_sync_debug_mode("error")`` to show that
   the step never synchronises with the host;
7. tables   — the routing tables of the three All2All fabrics built on
   the card (``minplus_hops`` products, mask packing, simulator set-up),
   with the build's peak device bytes; the card's distances equal the
   host BFS in the rows it computes (from every leaf of the first,
   middle and last leaf block and 64 seeded random leaves), the
   products number what the stopping rule predicts from the card's own
   leaf eccentricity, and for the Figure-6 MRLS the mask words equal
   the host's numpy packing of those three leaf blocks, each host step
   timed;
8. all2all  — the Figure-5 MRLS and both Figure-6 fabrics (MRLS f1 and
   the 50 %-depopulated Fat-Tree, 104,976 endpoints each) run an
   All2All of 16 rounds to completion through ``repro_torch.api.run``;
   each Result equals its ``tests/golden/torch_a2a_*.json`` field for
   field, and every kernel launched the expected number of times;
12. Figure 7 — run here, before the LM phases: the Dragonfly
   ``dragonfly(16, 8, 8)`` and Dragonfly+ ``dragonfly_plus(65, 16, 16,
   16, 16)`` under ugal and the MRLS ``mrls(1280, 19, 13)`` under
   Polarized, 16.5k endpoints each: tables on the card as in phase 7
   (but held against the host BFS from every leaf), the three All2All
   runs, the Dragonfly's uniform (300 + 300 slots), rep, rsp and bu
   (100 + 100) throughput and mice_elephant latency (100 + 100)
   through ``repro_torch.api.run``, each Result against its
   ``tests/golden/torch_fig7_*.json`` field for field with its launches,
   set-up and run seconds, slots/s and peak device bytes; the All2All
   completion ratio Dragonfly / MRLS; and a Dragonfly slot broken down
   as in phase 6;
13. Table 2, Figure 5's OFT row and the adversarial families — run after
   phase 12: every row of ``benchmarks/table2.py`` (12 fabrics up to
   23,328 switches) and ``jellyfish(614, 18, 18, seed=1)`` through
   ``build_tables`` (its default device, the card) and
   ``exact_metrics``, each against ``tests/golden/torch_table2.json``
   field for field with its host topology seconds, table seconds,
   products against the stopping rule and peak device bytes; then
   Figure 5's ``oft(17)`` under Polarized (All2All of 24 rounds,
   uniform 300 + 300, rep / rsp / bu 100 + 100, mice_elephant latency
   100 + 100) and ``tornado`` / ``shift`` / ``hotspot`` / ``bursty`` on
   the Figure-5 MRLS (100 + 100), each fabric through one ``run_all``
   with one ``SimulatorCache`` (one simulator built, ``minplus_hops``
   launched for that build alone), each Result against its
   ``tests/golden/torch_{fig5_oft,adv}_*.json`` with its launches, run
   seconds, slots/s and peak device bytes; and an OFT slot broken down
   as in phase 6;
14. workload programs — run after phase 13: the Rabenseifner allreduce
   of Figures 5 and 7 (8,192 ranks of 16 packets on ``oft(17)``, 16,384
   on ``dragonfly(16, 8, 8)`` under ugal; barrier schedule, 26 and 28
   phases) and the Figure-5 MRLS's 24 All2All rounds as a windowed
   program (``window`` 4); the Figure-5 MRLS allreduce is left to
   phases 15 (its replica 0) and 18 (point A), which hold it against
   the same golden; each fabric
   through one ``run_all`` with one ``SimulatorCache`` as in phase 13,
   each Result (``phase_slots`` included) against its
   ``tests/golden/torch_prog_*.json`` field for field with its
   launches, set-up and run seconds, slots/s and peak device bytes; then
   two barrier-program slots under the sync debug mode, and the device
   operations and device ms of a barrier-program slot beside a uniform
   slot of the Figure-5 MRLS (its tables from the windowed All2All's
   simulator), from ``torch.profiler``;
15. replicas — run after phase 14: ``switch_arbitrate_rows`` and
   ``vc_prearb`` at 4 replicas (``kernels/switch_arb/bench.py``'s
   ``run_replica_cases`` on seeded Figure-5 states, a different one a
   replica) bitwise against their plain versions and against one
   unbatched launch a replica, and their times
   (``time_replicas``); then Figure 5's MRLS row at the figure's 4
   replicas through one ``SimulatorCache``: the uniform point (300 + 300
   slots, seeds 0-3) through ``repro_torch.api.run`` against
   ``tests/golden/torch_rep_fig5_mrls_uniform_r4.json`` field for field
   and replica 0 against ``torch_fig5_mrls_u18.json``, and the
   Rabenseifner allreduce as four seed-only experiments through
   ``run_all`` (folded into one batched run) against
   ``torch_rep_fig5_mrls_allreduce_r4.json``, replica 0 against
   ``torch_prog_fig5_mrls_allreduce.json``; launches as a scalar run's
   (``vc_prearb`` 3 and ``switch_arbitrate_rows`` 2 a slot, whatever
   the replicas), run seconds, replica-slots/s and peak device bytes;
   two batched slots under the sync debug mode; and the R = 4 uniform
   slot, measured as phase 6 measures the scalar one, beside phase 6's
   (host ms, replica-slots/s, device ms, device operations, idle share)
   from ``torch.profiler``;
16. open-loop serving — run after phase 15: the arrival source's float32
   maps on the card over their whole domains, bitwise against the CPU
   (the pareto batch size of all 2^23 uniform draws for four (alpha,
   cap) pairs, the diurnal rate at slots 0 .. 2^16, glibc's ``sinf`` on
   2^20 seeded floats); then the two 1k-endpoint fabrics of
   ``examples/specs/serve_1k.json`` through one ``SimulatorCache`` —
   ``mrls(56, 18, 18, seed=1)`` under Polarized and ``fat_tree(16, 2)``
   under minimal_adaptive: ``serve_sweep`` of the MRLS poisson spec
   (loads 0.6 and 0.8, 100 + 200 slots, the ``qwen3-1.7b`` decode
   request over 8 ranks), Fat-Tree poisson at 0.8 with 4 replicas (100
   + 300) through ``repro_torch.api.run``, MRLS pareto (alpha 1.5, cap
   32) and diurnal (amplitude 0.5, period 64) at 0.6 (64 + 192), each
   record against its ``tests/golden/torch_serve_*.json`` field for
   field, with its launches (``vc_prearb`` 3 and
   ``switch_arbitrate_rows`` 2 a step), run seconds, slots/s, peak
   device bytes, pool stalls and drops; the conservation ledger
   ``arrived == backlog + sum(msg_rem) + created`` on the card's final
   states; two pareto and two diurnal slots under the sync debug mode;
   the host ms of a uniform, a poisson and a diurnal slot of the MRLS,
   and the diurnal slot's device ms, operations and idle share from the
   profiler, beside phase 6's uniform slot;
17. failures — run after phase 16, at ``benchmarks/bench_faults.py``'s
   settings (uniform 0.5, ``fail_seed`` 0) cut for time: ``degrade_sweep``
   of the 1k MRLS ``mrls(56, 18, 18, seed=1)`` under
   ``RouteSpec(policy="degraded", max_hops=12)`` at rates 0, 0.05 and
   0.10 (down at slot 10, requeue, 50 + 150 a rate); the Figure-5 MRLS
   (Polarized, ``max_hops`` 6) with 1 % of its links down at slot 20 and
   back at 60 under ``drop`` (40 + 60); ``fat_tree(16, 2)`` (degraded)
   with its first non-leaf switch down at 10 and up at 40 (20 + 40); and
   ``dragonfly(8, 4, 4)`` under ugal with an 8-link ladder from slot 10,
   a link every 8 slots (30 + 60); each record against its
   ``tests/golden/torch_fault_*.json`` field for field, with its
   launches (``vc_prearb`` 3 and ``switch_arbitrate_rows`` 2 a step,
   ``minplus_hops`` the build's products plus each delta rebuild's), run
   seconds, slots/s, peak device bytes and ``fail_drop``; every delta's
   rows bitwise the host BFS over the same effective adjacency
   (``UNREACHABLE`` where cut off) and its first mask words the host
   packing; the tables bitwise pristine after each run; the pool ledger
   (free + queued = pool) on each final state; two armed slots of each
   of polarized, degraded and ugal under the sync debug mode; the delta
   rebuild's seconds beside a full ``build_tables`` at the Figure-5 1 %
   set and the Fat-Tree switch event; and an armed degraded slot of the
   1k MRLS (5 % of its links down) beside the pristine one (host ms,
   device ms, operations, idle share);
18. resumable runtime — run after phase 17: the Figure-5 MRLS
   Rabenseifner allreduce of ``tests/golden/torch_prog_fig5_mrls_allreduce.json``
   as ``python -m repro_torch.api run <spec> --ckpt-dir D --ckpt-every 2``
   under ``runtime.supervisor.Supervisor`` (2 retries), whose ``popen``
   wrapper SIGKILLs the first child once ``D`` holds its second snapshot
   (on progress, not on a timer) and records at each attempt's start the
   latest snapshot and whether ``result.json`` exists; the retry resumes
   from a snapshot at step 2 or later; ``D/result.json`` equals the
   golden; each child's start-up (Popen to its first snapshot, less a
   segment) and its seconds a segment.  Then the 1k pareto serving point
   of ``tests/golden/torch_serve_mrls_pareto.json`` through
   ``run_resumable`` (every 64 slots, keep 8) in this process, equal to
   the golden; cut back to its snapshot at cursor 192 (``result.json``
   and the later snapshot deleted), ``resume`` equals the golden again;
   both runs' launches 3 × / 2 × the steps they ran.  Then ``D`` cut
   back to its oldest kept snapshot (``result.json`` and the later
   snapshots deleted) and resumed on the card through the CLI, as
   ``main(["resume", D, "--ckpt-every", "2"])`` in this process: its
   printed record equals the golden, its launches 3 × / 2 × its steps
   and ``minplus_hops`` its table build's; last, a snapshot's bytes and
   seconds (device to host, then the ``npz`` write) on the card;
19. memory, admission and search — run after phase 18: the port's byte
   model ``api.admission.device_peak_bytes`` against the peak device
   bytes (allocated and reserved) of the three All2All runs of phase 8,
   phase 15's 4-replica uniform run (its set-up included) and phase 16's
   1k pareto run, never below the reserved peak and at most 1.5 × it
   at 10k endpoints and above, with the step coefficients' fit to the
   Figure-5 runs at one and four replicas; the 100k Fat-Tree All2All at the
   smallest replica count the model prices over the card's budget:
   ``run`` raises ``AdmissionError`` with ``memory_allocated`` unchanged
   and no launch, and ``check_admission(mode="warn")`` admits it (not
   run); then ``examples/specs/search_1k.json``'s ``search_1k_uniform``
   cut to 6 candidates, screen 10 + 30 and full 30 + 60 slots and a 16
   MiB ``mem_budget_mib`` through ``repro_torch.search.search`` on the
   card: the record equals ``tests/golden/torch_search_1k_uniform_cut.json``
   field for field but ``predicted_device_bytes``, launches 3 × / 2 ×
   the steps and ``minplus_hops`` every table build's products (the
   pricing's metrics and the runs' simulators), each candidate run's
   set-up and run seconds, slots/s and peak bytes against the model;
9. LM kernels — ``flash_attention`` (causal, window ``None`` and 2,048, and
   ragged shapes: the cases of ``kernels/flash_attention/bench.py``, with
   its ``HGMMA``/``UTMALDG`` counts) and ``selective_scan`` (the cases of
   ``kernels/selective_scan/bench.py``: ``[4, 4096, 3200, 16]``, ragged
   ``Di`` and ``T`` not a multiple of the kernel's staged run, with its
   SASS counts and launch plan) against their plain PyTorch versions at
   the Hymba serving slice's shapes; kernel, plain and library (SDPA)
   times with CUDA events, and the bound (the scan's: bytes, float32
   operations or one MUFU ``ex2`` a state-step, whichever is largest);
10. Hymba golden — the full-width ``hymba-1.5b`` (weights from the seeded
   numpy synthesis), teacher-forced on the prompt and tokens of
   ``tests/golden/torch_hymba_1p5b_s4096.json``: the prefill's and 16
   decode steps' top-8 logits and logsumexp against the JAX reference's,
   and the top-1 wherever the reference's margin is clear;
11. serving — ``ServeSession.generate`` answers 4 requests of 4,096 tokens
   with 32 new tokens each (row 0 is the golden's prompt and must give its
   tokens); prefill seconds, decode ms per token, tokens/s, peak device
   memory, the kernels' launches (32 + 32 per prefill, none per decode
   step), and where a prefill's time goes from ``torch.profiler``.

Each phase prints its wall seconds, and the script its total.  The
kernels' launches on the main paths of phases 8, 12, 13, 14, 15, 16, 17,
18 (its in-process runs), 19 and 11 are summed.  The last lines are a
``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` name and
power limit, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/`` beside it, the script exits with code 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SHORT_GOLDEN = ROOT / "tests" / "golden" / "torch_engine_parity_short.json"
FIG5_GOLDEN = ROOT / "tests" / "golden" / "torch_fig5_mrls_u18.json"
# the All2All points of phases 7 and 8, smallest first
A2A_GOLDENS = {
    label: ROOT / "tests" / "golden" / f"torch_a2a_{name}.json"
    for label, name in (("fig5.mrls_u18", "fig5_mrls_u18"),
                        ("fig6.mrls_f1", "fig6_mrls_f1"),
                        ("fig6.ft50", "fig6_ft50"))}

# the Figure-7 points of phase 12: the three All2All runs, smallest
# first, then the Dragonfly's Bernoulli runs
FIG7_GOLDENS = [ROOT / "tests" / "golden" / f"torch_fig7_{name}.json"
                for name in ("mrls_u19_pol_a2a", "dfplus_ugal_a2a",
                             "df_ugal_a2a", "df_ugal_thpt_uniform",
                             "df_ugal_thpt_rep", "df_ugal_thpt_rsp",
                             "df_ugal_thpt_bu", "df_ugal_lat_mice_elephant")]

# phase 13: Table 2's rows, Figure 5's OFT row (the All2All first) and
# the adversarial families on the Figure-5 MRLS
TABLE2_GOLDEN = ROOT / "tests" / "golden" / "torch_table2.json"
FIG5_OFT_GOLDENS = [ROOT / "tests" / "golden" / f"torch_fig5_oft_{name}.json"
                    for name in ("a2a", "thpt_uniform", "thpt_rep",
                                 "thpt_rsp", "thpt_bu", "lat_mice_elephant")]
ADV_GOLDENS = [ROOT / "tests" / "golden" / f"torch_adv_{name}.json"
               for name in ("tornado", "shift", "hotspot", "bursty")]

# phase 14: the workload programs, grouped by fabric and routing; the
# uninterrupted Figure-5 MRLS allreduce (PROG_GOLDENS[0]) is checked by
# phase 15 (its replica 0) and phase 18 (point A), so phase 14 leaves it
PROG_GOLDENS = [ROOT / "tests" / "golden" / f"torch_prog_{name}.json"
                for name in ("fig5_mrls_allreduce", "fig5_mrls_a2a_window",
                             "fig5_oft_allreduce", "fig7_df_allreduce")]
PHASE14_GOLDENS = PROG_GOLDENS[1:]

# phase 15: Figure 5's MRLS row at the figure's 4 replicas
REP_UNIFORM_GOLDEN = (ROOT / "tests" / "golden"
                      / "torch_rep_fig5_mrls_uniform_r4.json")
REP_ALLREDUCE_GOLDEN = (ROOT / "tests" / "golden"
                        / "torch_rep_fig5_mrls_allreduce_r4.json")

# phase 16: open-loop serving on the 1k-endpoint SLO fabrics
SERVE_SWEEP_GOLDEN = (ROOT / "tests" / "golden"
                      / "torch_serve_mrls_poisson_sweep.json")
SERVE_GOLDENS = [ROOT / "tests" / "golden" / f"torch_serve_{name}.json"
                 for name in ("ft_poisson_r4", "mrls_pareto",
                              "mrls_diurnal")]
# phase 17: failures on the 1k fabrics and the Figure-5 MRLS
FAULT_SWEEP_GOLDEN = ROOT / "tests" / "golden" / "torch_fault_mrls1k_sweep.json"
FAULT_GOLDENS = [ROOT / "tests" / "golden" / f"torch_fault_{name}.json"
                 for name in ("fig5_mrls_drop", "ft1k_switch", "df1k_ugal")]
# phase 18: the resumable runtime
KILL_GOLDEN = ROOT / "tests" / "golden" / "torch_prog_fig5_mrls_allreduce.json"
RESUME_GOLDEN = ROOT / "tests" / "golden" / "torch_serve_mrls_pareto.json"
# phase 18's checkpoint directories (build/ is git-ignored)
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
# phase 19: the cut 1k design-space search (SearchSpec and the
# reference's record); the admission refusal takes the 100k Fat-Tree
SEARCH_GOLDEN = ROOT / "tests" / "golden" / "torch_search_1k_uniform_cut.json"
# the model's bounds against a measured reserved peak: never below it, and
# at most this multiple of it at this many endpoints and above
MODEL_OVER = 1.5
MODEL_OVER_FROM = 10_000
# the (alpha, cap) pairs whose batch map phase 16 checks on the card, and
# the (load, amplitude, period) of its diurnal rates
PARETO_MAPS = ((1.5, 16), (1.5, 32), (1.5, 64), (1.2, 64))
DIURNAL_RATES = ((0.6, 0.5, 64), (0.3, 0.9, 1000))

HYMBA_GOLDEN = ROOT / "tests" / "golden" / "torch_hymba_1p5b_s4096.json"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, outside tensor cores
# kernel -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "vc_prearb": ("src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu",
                  "src/repro/kernels/switch_arb/kernel.py:64"),
    "switch_arbitrate": (
        "src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu",
        "src/repro/kernels/switch_arb/kernel.py:113"),
    "switch_arbitrate_rows": (
        "src/repro_torch/kernels/switch_arb/csrc/switch_arb.cu",
        "src/repro/kernels/switch_arb/kernel.py:113"),
    "minplus": ("src/repro_torch/kernels/minplus/csrc/minplus.cu",
                "src/repro/kernels/minplus/kernel.py:42"),
    "minplus_hops": ("src/repro_torch/kernels/minplus/csrc/minplus.cu",
                     "src/repro/kernels/minplus/kernel.py:42"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:73"),
    "selective_scan": (
        "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        "src/repro/kernels/selective_scan/kernel.py:39"),
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)

# label -> {"exp", "peak", "peak_reserved"}: the runs of phases 8, 15 and
# 16 whose peak device bytes phase 19 holds the memory model against
MEASURED = {}

_PHASE = {"name": None, "t0": 0.0}
T_START = time.perf_counter()


def phase(name=None) -> None:
    """Print the wall seconds of the phase that ends, then start ``name``."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.3f} s wall",
              flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
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


def bound_ms(n_bytes: int, ops: int):
    """(least ms, "bytes" or "operations") at the card's memory rate and
    float32 rate (the attention kernel's bound is its bench module's)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_modules() -> list:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.minplus import kernel as mp
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.kernels.switch_arb import kernel as arb
    return [arb, mp, fa, ss]


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for m in _kernel_modules():
        m.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since the last :func:`reset_counts`."""
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts())
    return out


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


def run_kernels(geos: dict) -> dict:
    """Bitwise kernel-vs-plain checks of the crossbar kernels and their
    timings at the Figure-5 geometry (``kernels/switch_arb/bench.py``);
    returns their records."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.switch_arb import bench, kernel
    phase("3. kernels vs plain, on the card")
    lib = _build.build_all(["switch_arb"])["switch_arb"]["path"]
    print(f"SASS of the crossbar kernels: {bench.sass_counts(lib)}")
    for g in geos.values():
        shared = kernel._lib().switch_arbitrate_rows_smem(g.p, bench.V, g.d)
        print(f"{g.label}: N={g.n} P={g.p} d={g.d} NR={g.nr}; "
              f"switch_arbitrate_rows takes {shared} bytes of shared memory "
              f"a block (at most {kernel.MAX_DYNAMIC_SHARED_BYTES})")
    gen = torch.Generator(device="cuda").manual_seed(18)
    errs = bench.run_cases(geos, gen)
    timed = bench.time_point(geos["fig5"], gen)
    floor = timed["empty kernel, 1 x 256 threads"]
    print(f"empty kernel: {floor['ms'] * 1e3:.3f} us back to back, "
          f"{(floor['device_ms'] or 0) * 1e3:.3f} us on the device: the "
          "floor of these timings")
    main = bench.rows_label(kernel.ROWS_MAIN_LANES)
    records = {}
    for name, label in (("vc_prearb", "vc_prearb + gather"),
                        ("switch_arbitrate", "switch_arbitrate (dense)"),
                        ("switch_arbitrate_rows", main)):
        t = timed[label]
        records[name] = dict(max_abs_err=errs[name],
                             ms=t["device_ms"] or t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                             bound_by="bytes")
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


def rule_products(ecc: int, n: int, n_rows: int) -> int:
    """``minplus_hops`` products of a table build whose needed rows (the
    ``n_rows`` leaves of ``n`` switches) have eccentricity ``ecc``: K
    squarings with ``ecc < 2**K``, each in two products (the needed rows,
    rounded up to 8, then the others) but the last, which stops after
    the needed rows."""
    squarings = ecc.bit_length()
    if not squarings:
        return 0
    split = min(-(-n_rows // 8) * 8, n)
    return (1 if split >= n else 2) * (squarings - 1) + 1


def run_minplus_hops(topos: dict) -> dict:
    """The int16 ``minplus_hops`` kernel: DPX issue rate, SASS, bitwise
    cases, times at N = 921 (the record), and every product of each
    fabric's table build in ``topos`` through the wrapper the build calls,
    timed with CUDA events and its first, middle and last row blocks
    held bitwise against the plain version."""
    import torch
    from repro_torch.core.routing import hop_distances
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import bench, kernel, ref
    dev = torch.device("cuda")
    lib_path = _build.build_all(["minplus"])["minplus"]["path"]
    sass = (bench.sass_counts(lib_path) or {}).get("minplus_hops_kernel")
    print(f"SASS of minplus_hops_kernel: {sass}")
    if sass is not None and not sass["VIADDMNMX"]:
        raise AssertionError("minplus_hops_kernel has no VIADDMNMX")
    rates = [bench.probe(op) for op in (0, 1)]
    for r in rates:
        print(f"DPX probe {r['op']}: {r['per_clock']:.3f} instructions per "
              f"SM per clock = {r['triples_per_clock']:.3f} (min, +) "
              f"triples; SM clock {r['sm_clock_ghz']:.4f} GHz")
    tpc = rates[0]["triples_per_clock"]
    err = bench.run_cases()
    rec = bench.time_921(tpc)
    print(f"minplus_hops N=921: kernel {rec['ms']:.6f} ms per launch (50 "
          f"launches), bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it; float32 "
          f"kernel's bound {rec['fp32_bound_ms']:.6f} ms); plain "
          f"{rec['plain_ms']:.6f} ms")

    seen = []
    wrapper = kernel.minplus_hops

    def checked(at, b, out=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        c = wrapper(at, b, out)
        ev[1].record()
        torch.cuda.synchronize()
        m, blk = c.shape[0], 128
        rows = sorted({0, (m // 2) // blk * blk, max(m - blk, 0)})
        for lo in rows:
            if not torch.equal(c[lo:lo + blk],
                               ref.minplus_hops_ref(at[:, lo:lo + blk], b)):
                raise AssertionError(f"minplus_hops differs from its plain "
                                     f"version at rows {lo}:{lo + blk} of "
                                     f"product {len(seen) + 1}")
        seen.append((m, b.shape[1], at.shape[0], ev[0].elapsed_time(ev[1]),
                     [(r, min(r + blk, m)) for r in rows]))
        return c

    kernel.minplus_hops = checked
    try:
        for label, topo in topos.items():
            seen.clear()
            _, _, products = hop_distances(topo.nbrs, topo.leaf_ids, dev)
            torch.cuda.synchronize()
            for i, (m, n, k, ms, rows) in enumerate(seen):
                bnd, by = bench.hops_bound_ms(m, n, k, tpc)
                print(f"minplus_hops {label} product {i + 1} of {products}"
                      f": [{k},{m}]^T x [{k},{n}] {ms:.6f} ms, bound "
                      f"{bnd:.6f} ms ({by}, {100 * bnd / ms:.1f}% of it), "
                      f"float32 kernel's bound "
                      f"{bench.fp32_bound_ms(m, n, k):.6f} ms; rows {rows} "
                      "bitwise equal to the plain version")
            torch.cuda.empty_cache()
    finally:
        kernel.minplus_hops = wrapper
    return dict(max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"])


def run_golden():
    import numpy as np
    from repro_torch.core import build_tables, mrls
    from repro_torch.simulator.engine import SimConfig, Simulator, Traffic
    phase("4. golden replay on the card")
    g = json.loads(SHORT_GOLDEN.read_text())
    tables = build_tables(mrls(**g["fabric"]), device="cuda")
    for policy in ("polarized", "minimal_adaptive", "ksp", "ugal",
                   "valiant"):
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


def expected_counts(exp, slots: int, squarings: int) -> dict:
    speedup = exp.route.speedup
    return {**NO_LAUNCHES, "vc_prearb": (speedup + 1) * slots,
            "switch_arbitrate_rows": speedup * slots,
            "minplus_hops": squarings}


def run_breakdown(tables, exp) -> tuple:
    """Where one slot of the Fig-5 fabric spends its time on the card.
    Returns :func:`breakdown`'s (kernel ms a launch, slot costs)."""
    phase("6. breakdown of a Fig-5 slot")
    return breakdown(tables, exp)


def host_ms(step, n: int) -> float:
    """Host milliseconds per call of ``n`` calls of ``step()``, the card
    synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def no_sync(step, n: int) -> None:
    """``n`` calls of ``step()`` under the sync debug mode: a step must
    never wait for the device, and any synchronising call (.item(),
    nonzero, a boolean-mask index) raises in this mode."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def profile_slots(step, n: int) -> tuple:
    """``n`` calls of ``step()`` under ``torch.profiler``: (the profiled
    wall ms per call, the device-side rows (self device us, count, name),
    longest first).  The device alone is traced (kernels, copies, sets):
    CPU-side aten rows would carry their kernels' time too and count it
    twice, and collecting them costs the profiler seconds a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.count,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return wall_ms, rows


def device_load(rows, n: int) -> tuple:
    """(device-busy ms, device operations) per call of the ``n`` calls
    that :func:`profile_slots` profiled into ``rows``."""
    return sum(r[0] for r in rows) / n / 1e3, sum(r[1] for r in rows) / n


def breakdown(tables, exp) -> tuple:
    """Where one slot of ``exp``'s uniform traffic on ``tables``' fabric
    spends its time on the card: steady-state ms per slot, per-phase CUDA
    events, the slot's PRNG draws alone, two slots under the sync debug
    mode, and the profiler's device time and idle share.  Returns (each
    kernel's device ms per launch, empty if the profiler saw no device
    events; the slot's ``{"ms", "busy_ms", "ops"}``)."""
    import torch
    from repro_torch import prng
    from repro_torch.simulator.engine import Simulator, Traffic
    sim = Simulator(tables, exp.route.to_sim_config(), device="cuda")
    tr = Traffic(exp.workload.pattern, load=exp.workload.load)
    # the step functions take batched states: one replica of exp.seed
    st = sim.make_batch_state(tr, [exp.seed])
    sim.run_chunk(st, tr, 100)                  # into steady state
    n = 50
    slot_ms = host_ms(lambda: sim._step(st, tr), n)
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
        if sim.cfg.policy in ("ugal", "valiant"):
            prng.randint(key, (S,), 0, sim.n1, partitionable=pt)
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
            st["key"], 3 + sim.cfg.speedup,
            partitionable=sim._pt).unbind(-2)
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

    no_sync(lambda: sim._step(st, tr), 2)
    print("2 slots under torch.cuda.set_sync_debug_mode('error'): the step "
          "makes no host synchronisation")

    n_prof = 10
    wall_ms, rows = profile_slots(lambda: sim._step(st, tr), n_prof)
    busy_ms, launches = device_load(rows, n_prof)
    cost = {"ms": slot_ms, "busy_ms": busy_ms, "ops": launches}
    if busy_ms <= 0:
        print("profiler: device time not measured (no device events)")
        return {}, cost
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
    return per_launch, cost


def run_tables(points: dict) -> dict:
    """Routing tables of each All2All fabric built on the card, timed;
    the card's distances against the host BFS, and the Figure-6 MRLS's
    mask words against the host packing.  Returns each point's
    minplus_hops products."""
    phase("7. routing tables on the card")
    return check_tables(points, sample=True)


# phase 7's host BFS: from the first, middle and last leaf block and
# this many seeded random leaves
BFS_RANDOM_LEAVES = 64


def sampled_leaves(n_leaves: int, block: int):
    """(sorted leaf ranks, their leaf blocks): every leaf of the first,
    middle and last block of ``block`` rows, and ``BFS_RANDOM_LEAVES``
    leaves drawn by a seeded numpy generator."""
    import numpy as np
    n_blocks = -(-n_leaves // block)
    blocks = sorted({0, n_blocks // 2, n_blocks - 1})
    rows = {r for b in blocks
            for r in range(b * block, min((b + 1) * block, n_leaves))}
    rng = np.random.default_rng(0)
    rows.update(rng.choice(n_leaves, min(BFS_RANDOM_LEAVES, n_leaves),
                           replace=False).tolist())
    return np.array(sorted(rows), np.int64), blocks


def check_tables(points: dict, sample: bool = False) -> dict:
    """For each point's fabric: the routing tables and the simulator
    set-up on the card, timed, with the build's peak device bytes; the
    card's ``dist_leaf`` against the host BFS, row for row, from every
    leaf or, with ``sample``, from the leaves of :func:`sampled_leaves`;
    the products against the stopping rule at the card's own leaf
    eccentricity (and, for the Figure-6 MRLS, the mask words of the
    first, middle and last leaf block against the host packing).
    Returns each point's minplus_hops products."""
    import numpy as np
    import torch
    from repro_torch.api import build_network
    from repro_torch.core import bfs_distances, build_tables
    from repro_torch.core.routing import _pack_mask_block
    from repro_torch.simulator.engine import Simulator
    squarings = {}
    for label, exp in points.items():
        t0 = time.perf_counter()
        topo = build_network(exp.network)
        t_topo = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tables = build_tables(topo, device="cuda")
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        sim = Simulator(tables, exp.route.to_sim_config(), device="cuda")
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0 - t_tab
        check_counts(read_counts(), {**NO_LAUNCHES,
                                     "minplus_hops": tables.squarings},
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
              f"({tables.squarings} minplus_hops products and the int16 "
              f"leaf rows; peak device memory {peak} bytes above the "
              f"{held} held before it) + "
              f"Simulator.__init__ {t_sim:.3f} s; the device mask "
              f"packing alone, run again: {t_masks:.3f} s for "
              f"{-(-topo.n_leaves // tables.leaf_block)} leaf blocks")
        rows, blocks = sampled_leaves(topo.n_leaves, tables.leaf_block)
        if not sample:
            rows = np.arange(topo.n_leaves)
        t0 = time.perf_counter()
        bfs = bfs_distances(topo, topo.leaf_ids[rows])
        t_bfs = time.perf_counter() - t0
        same = np.array_equal(
            bfs, tables.dist_leaf[torch.as_tensor(rows, device="cuda")]
            .cpu().numpy())
        ecc = int(tables.dist_leaf.max())
        want = rule_products(ecc, topo.n_switches, topo.n_leaves)
        source = (f"{len(rows)} of the {topo.n_leaves} leaves (leaf "
                  f"blocks {blocks} of {tables.leaf_block} rows and "
                  f"{BFS_RANDOM_LEAVES} seeded random leaves)" if sample
                  else f"all {topo.n_leaves} leaves")
        print(f"{label}: host BFS from {source} "
              f"{t_bfs:.3f} s; the card's dist_leaf "
              f"{'equals' if same else 'DIFFERS FROM'} it in those rows, "
              f"element for element; leaf eccentricity on the card {ecc} "
              f"(the BFS rows' {int(bfs.max())}), so the stopping rule "
              f"takes {want} products (the build took {tables.squarings})")
        if not same:
            raise AssertionError(f"dist_leaf from minplus_hops differs from "
                                 f"the BFS on {label}")
        if tables.squarings != want:
            raise AssertionError(f"{label}: {tables.squarings} products, "
                                 f"the stopping rule predicts {want}")
        if label == "fig6.mrls_f1":
            nbrs = topo.nbrs
            valid = nbrs >= 0
            nbr_safe = np.where(valid, nbrs, 0)
            n, w, blk = sim.N, sim.W, tables.leaf_block
            n_blocks = -(-topo.n_leaves // blk)
            checked = blocks
            host_s = []
            for b in checked:
                lo, hi = b * blk, min((b + 1) * blk, topo.n_leaves)
                at = np.searchsorted(rows, np.arange(lo, hi))
                t0 = time.perf_counter()
                min_b, away_b = _pack_mask_block(bfs[at], nbrs, valid,
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


@contextlib.contextmanager
def timed_runs(timing: list, peaks: bool = False):
    """Append to ``timing`` the seconds (``run_s``) and the slots
    (``slots_run``: the steps it took; a barrier program sets its state's
    slot back at every phase) of each ``Simulator`` measurement run, read
    around the user's call without changing it; with ``peaks``, also the
    peak device bytes of the run alone, allocated (``peak``) and reserved
    by PyTorch's caching allocator (``peak_reserved``): the peak
    statistics are reset before it."""
    import torch
    from repro_torch.simulator.engine import Simulator
    saved = {name: getattr(Simulator, name) for name in
             ("run_completion", "run_throughput", "run_latency",
              "run_program", "run_throughput_batch", "run_latency_batch",
              "run_serving", "run_serving_batch", "run_resilience",
              "_step")}
    steps = [0]

    def counted(self, *args, **kw):
        steps[0] += 1
        return saved["_step"](self, *args, **kw)

    def timed(fn):
        def call(self, *args, **kw):
            torch.cuda.synchronize()
            if peaks:
                torch.cuda.reset_peak_memory_stats()
            steps[0] = 0
            t0 = time.perf_counter()
            r = fn(self, *args, **kw)
            torch.cuda.synchronize()
            timing.append(dict(
                run_s=time.perf_counter() - t0, slots_run=steps[0],
                peak=torch.cuda.max_memory_allocated() if peaks else None,
                peak_reserved=(torch.cuda.max_memory_reserved() if peaks
                               else None)))
            return r
        return call

    for name, fn in saved.items():
        setattr(Simulator, name, counted if name == "_step" else timed(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(Simulator, name, fn)


def run_points(points: dict, squarings: dict,
               measured: bool = False) -> tuple:
    """Each point ``{label: (Experiment, golden Result dict, golden file
    name)}`` through ``repro_torch.api.run`` on the card: its Result
    against the golden field for field, its launches against the counts
    the slots it ran and the table build's ``squarings[label]`` give, its
    set-up and run seconds, slots/s and peak device bytes, allocated and
    reserved (the cache is emptied before each point, so the peaks are
    the point's own, its table build included; with ``measured``, phase
    19 holds the memory model against them through ``MEASURED``).
    Returns (launches summed
    over the points, {label: completion slot})."""
    import torch
    from repro_torch.api import run
    timing = []
    total = dict.fromkeys(KERNELS, 0)
    slots = {}
    with timed_runs(timing):
        for label, (exp, golden, fname) in points.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = run(exp, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            rec = timing.pop()
            run_s = rec["run_s"]
            ran = rec["slots_run"]
            got = res.to_dict()
            stats = {k: v for k, v in got.items()
                     if v is not None and k not in ("experiment", "metric")}
            peak = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved()
            if measured:
                MEASURED[label] = dict(exp=exp, peak=peak,
                                       peak_reserved=peak_reserved)
            print(f"{label}: {res.metric} {stats}; {ran} slots run (chunk "
                  f"{exp.chunk}); {wall:.3f} s end to end = set-up "
                  f"{wall - run_s:.3f} s + run {run_s:.3f} s "
                  f"({ran / run_s:.2f} slots/s); peak device memory "
                  f"{peak} bytes allocated, {peak_reserved} reserved")
            if got != golden:
                diff = {k: (got.get(k), golden.get(k)) for k in golden
                        if got.get(k) != golden.get(k)}
                raise AssertionError(f"{label} Result differs from the JAX "
                                     f"reference: {diff}")
            print(f"{label}: Result equals {fname} field for field")
            check_counts(counts, expected_counts(exp, ran, squarings[label]),
                         f"the {label} run")
            for k in total:
                total[k] += counts[k]
            if res.metric == "completion":
                slots[label] = res.slots
    return total, slots


def run_all2all(points: dict, squarings: dict) -> dict:
    """Each All2All point through ``repro_torch.api.run`` on the card,
    against its golden; returns the launches summed over the points."""
    phase("8. All2All to completion through repro_torch.api.run")
    total, slots = run_points(
        {label: (exp, json.loads(A2A_GOLDENS[label].read_text()),
                 A2A_GOLDENS[label].name)
         for label, exp in points.items()}, squarings, measured=True)
    print(f"Fat-Tree / MRLS completion slots at 104,976 endpoints: "
          f"{slots['fig6.ft50']} / {slots['fig6.mrls_f1']} = "
          f"{slots['fig6.ft50'] / slots['fig6.mrls_f1']:.4f} (simulated "
          "slots, a simulation output)")
    return total


def fig7_points() -> dict:
    """``{name: (Experiment, golden Result dict, golden file name)}`` of
    phase 12."""
    from repro_torch.api import Experiment
    out = {}
    for path in FIG7_GOLDENS:
        golden = json.loads(path.read_text())
        exp = Experiment.from_dict(golden["experiment"])
        out[exp.name] = (exp, golden, path.name)
    return out


def run_fig7(points: dict) -> dict:
    """Figure 7 at the paper's size through ``repro_torch.api.run``: each
    fabric's tables on the card against the host BFS and the stopping
    rule, then every point against its golden, and the Dragonfly's slot
    broken down.  Returns the launches summed over the points."""
    import torch
    from repro_torch.api import build_network
    from repro_torch.core import build_tables
    phase("12. Figure 7: Dragonfly, Dragonfly+ and MRLS u19 at 16.5k "
          "endpoints")
    # one table build a fabric, at its first point
    first = {}
    for label, (exp, _, _) in points.items():
        first.setdefault(exp.network, label)
    built = check_tables({label: points[label][0]
                          for label in first.values()})
    total, slots = run_points(points, {
        label: built[first[exp.network]]
        for label, (exp, _, _) in points.items()})
    df = slots["fig7.df.ugal.all2all"]
    mrls = slots["fig7.mrls_u19.pol.all2all"]
    print(f"All2All completion slots, Dragonfly (ugal) / MRLS u19 "
          f"(Polarized) at 16.5k endpoints: {df} / {mrls} = {df / mrls:.4f}; "
          f"Dragonfly+ (ugal): {slots['fig7.dfplus.ugal.all2all']} (simulated "
          "slots; the all2all is a near-neighbour shift, not the paper's "
          "collective)")

    exp = points["fig7.df.ugal.thpt.uniform"][0]
    tables = build_tables(build_network(exp.network), device="cuda")
    print("breakdown of a Dragonfly slot under ugal, uniform load "
          f"{exp.workload.load}:")
    breakdown(tables, exp)
    del tables
    torch.cuda.empty_cache()
    return total


def run_table2() -> dict:
    """Every row of Table 2 (and the jellyfish design) through
    ``build_tables`` on the card (its default device) and
    ``exact_metrics``: each row's host topology seconds, table seconds,
    products against the stopping rule (the leaf eccentricity read from
    the card's own ``dist_leaf``) and peak device bytes, and its metrics
    against the reference's in ``tests/golden/torch_table2.json``, field
    for field (A as a float64, bit for bit).  Returns the launches summed
    over the rows."""
    import dataclasses
    import torch
    from repro_torch.api import NetworkSpec, build_network
    from repro_torch.core import build_tables, exact_metrics
    rows = json.loads(TABLE2_GOLDEN.read_text())["rows"]
    total = dict.fromkeys(KERNELS, 0)
    for row in rows:
        label = row["label"]
        t0 = time.perf_counter()
        topo = build_network(NetworkSpec.from_dict(row["network"]))
        t_topo = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        tables = build_tables(topo)
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = dataclasses.asdict(exact_metrics(topo, tables))
        t_metrics = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - held
        ecc = int(tables.dist_leaf.max())
        want = rule_products(ecc, topo.n_switches, topo.n_leaves)
        print(f"{label}: N={topo.n_switches} N1={topo.n_leaves} "
              f"S={topo.n_endpoints} P={topo.max_ports}; topology "
              f"{t_topo:.3f} s on the host; tables on the card "
              f"{t_tab:.3f} s ({tables.squarings} minplus_hops products; "
              f"leaf eccentricity {ecc} on the card, so the stopping rule "
              f"takes {want}); metrics {t_metrics:.3f} s; peak device "
              f"memory {peak} bytes above the {held} held before")
        if tables.squarings != want:
            raise AssertionError(f"{label}: {tables.squarings} products, "
                                 f"the stopping rule predicts {want}")
        check_counts(counts, {**NO_LAUNCHES,
                              "minplus_hops": tables.squarings},
                     f"the {label} table build")
        paper = row["paper"] or {}
        print(f"{label}: A={got['A']!r} D={got['D']} D*={got['D_star']} "
              f"Theta={got['theta']:.4f} C_links={got['cost_links']:.4f} "
              f"C_switches={got['cost_switches']:.4f}; the paper: "
              + (", ".join(f"{k} {v}" for k, v in paper.items())
                 or "no row"))
        if got != row["metrics"]:
            diff = {k: (got[k], row["metrics"][k]) for k in got
                    if got[k] != row["metrics"][k]}
            raise AssertionError(f"{label}: exact_metrics differs from the "
                                 f"reference: {diff}")
        for k in total:
            total[k] += counts[k]
        del tables
        torch.cuda.empty_cache()
    print(f"all {len(rows)} rows equal {TABLE2_GOLDEN.name} field for field")
    return total


def golden_points(paths) -> list:
    """``[(Experiment, golden Result dict, golden file name)]``."""
    from repro_torch.api import Experiment
    out = []
    for path in paths:
        golden = json.loads(path.read_text())
        out.append((Experiment.from_dict(golden["experiment"]), golden,
                    path.name))
    return out


def run_shared(points: list) -> tuple:
    """The points of one fabric and routing through one ``run_all`` with
    one ``SimulatorCache``, as ``benchmarks/bench_sim.run_scenario``
    runs a fabric's experiments: the cache's one simulator is built
    first (set-up seconds and peak bytes, ``minplus_hops`` products
    against the stopping rule), then ``run_all`` takes it from the
    cache.  Each Result against its golden field for field, with its run
    seconds, slots/s, pool stalls and the run's own peak device bytes;
    the launches of the whole path against the slots run and the one
    table build.  Returns (launches, the simulator's tables)."""
    import torch
    from repro_torch.api import SimulatorCache, run_all
    exps = [exp for exp, _, _ in points]
    network, route = exps[0].network, exps[0].route
    assert all((e.network, e.route) == (network, route) for e in exps)
    timing = []
    with SimulatorCache() as cache, timed_runs(timing, peaks=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        sim = cache.get(network, route)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        tables = sim.tables
        ecc = int(tables.dist_leaf.max())
        want = rule_products(ecc, sim.N, sim.n1)
        print(f"{network.family} {network.param_dict()}: N={sim.N} "
              f"N1={sim.n1} S={sim.S} P={sim.P}; set-up through the cache "
              f"{t_setup:.3f} s (topology, {tables.squarings} minplus_hops "
              f"products, masks; the stopping rule takes {want} at leaf "
              f"eccentricity {ecc}); peak device memory {peak} bytes above "
              f"the {held} held before")
        if tables.squarings != want:
            raise AssertionError(f"{tables.squarings} products, the "
                                 f"stopping rule predicts {want}")
        t0 = time.perf_counter()
        results = run_all(exps, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if len(cache) != 1:
            raise AssertionError(f"the cache holds {len(cache)} simulators")
        ran_total = 0
        for (exp, golden, fname), res, rec in zip(points, results, timing):
            ran = rec["slots_run"]
            ran_total += ran
            got = res.to_dict()
            stats = {k: v for k, v in got.items()
                     if v is not None and k not in ("experiment", "metric")}
            print(f"{exp.name}: {res.metric} {stats}; {ran} slots in "
                  f"{rec['run_s']:.3f} s ({ran / rec['run_s']:.2f} slots/s)"
                  f"; peak device memory of the run {rec['peak']} bytes")
            if got != golden:
                diff = {k: (got.get(k), golden.get(k)) for k in golden
                        if got.get(k) != golden.get(k)}
                raise AssertionError(f"{exp.name} Result differs from the "
                                     f"JAX reference: {diff}")
            print(f"{exp.name}: Result equals {fname} field for field")
        print(f"run_all of {len(exps)} experiments: {wall:.3f} s, "
              f"{sum(r['run_s'] for r in timing):.3f} s of it in the runs")
        check_counts(counts, {
            **NO_LAUNCHES, "minplus_hops": tables.squarings,
            "vc_prearb": (route.speedup + 1) * ran_total,
            "switch_arbitrate_rows": route.speedup * ran_total},
            f"the run_all of {network.family}")
    return counts, tables


def run_phase13() -> dict:
    """Table 2, Figure 5's OFT row and the adversarial families at the
    paper's size.  Returns the launches summed over their main paths."""
    import torch
    phase("13. Table 2, Figure 5's OFT row and the adversarial families")
    total = run_table2()
    oft = golden_points(FIG5_OFT_GOLDENS)
    counts, tables = run_shared(oft)
    for k in total:
        total[k] += counts[k]
    exp = next(e for e, _, _ in oft if e.workload.pattern == "uniform")
    print("breakdown of an OFT slot under Polarized, uniform load "
          f"{exp.workload.load}:")
    breakdown(tables, exp)
    del tables
    counts, tables = run_shared(golden_points(ADV_GOLDENS))
    for k in total:
        total[k] += counts[k]
    del tables
    torch.cuda.empty_cache()
    return total


def program_slot_costs(tables, exp) -> None:
    """A barrier-program slot of ``exp`` (an allreduce) beside a uniform
    slot of the same fabric: two program slots under the sync debug mode,
    then each slot's host ms, device ms and device operations, and those
    of the phase scheduler (``_advance_program``) alone.  The uniform
    slot is measured as :func:`breakdown` measures it: 100 slots into
    steady state, the host time over 50 and the profile over 10."""
    from repro_torch.api.runner import _collective_program
    from repro_torch.simulator.engine import Simulator, Traffic
    sim = Simulator(tables, exp.route.to_sim_config(), device="cuda")
    cp = _collective_program(sim, exp)
    tr = sim.program_traffic(cp)
    st = sim.make_program_batch_state(cp, [exp.seed])
    kw = dict(chunk=exp.chunk, max_slots=exp.max_slots)
    for _ in range(20):                         # past the first phase
        sim._step(st, tr, **kw)
    # the scheduler's gathers and resets must not wait for the device
    no_sync(lambda: sim._step(st, tr, **kw), 2)
    print("2 barrier-program slots under torch.cuda.set_sync_debug_mode("
          "'error'): the program step makes no host synchronisation")

    def costs(step, n_host, n_prof=10):
        """(host ms, device-busy ms, device operations) per call."""
        ms = host_ms(step, n_host)
        return (ms, *device_load(profile_slots(step, n_prof)[1], n_prof))

    prog = costs(lambda: sim._step(st, tr, **kw), 10)
    # the scheduler alone, mid-phase (no crossing: it writes back what it
    # reads)
    ph = int(st["phase"])
    sched = costs(
        lambda: sim._advance_program(st, tr, kw["chunk"], kw["max_slots"]),
        10)
    if int(st["phase"]) != ph:
        raise AssertionError("the scheduler crossed a phase on its own")
    uni = Traffic("uniform", load=1.0)
    st = sim.make_batch_state(uni, [exp.seed])
    sim.run_chunk(st, uni, 100)                 # into steady state
    bern = costs(lambda: sim._step(st, uni), 50)
    for label, (ms, busy_ms, ops) in (
            (f"barrier-program slot ({cp.name}, slots 23-42 of the run)",
             prog), ("phase scheduler alone (_advance_program)", sched),
            ("uniform slot (load 1.0, past 100 slots)", bern)):
        if busy_ms <= 0:
            print(f"{label}: host {ms:.4f} ms; device time not "
                  "measured (the profiler saw no device events)")
            continue
        print(f"{label}: host {ms:.4f} ms ({1e3 / ms:.2f} "
              f"slots/s), device busy {busy_ms:.4f} ms in {ops:.0f} device "
              f"operations, idle share {100 * (1 - busy_ms / ms):.1f}%")
    if prog[1] > 0 and bern[1] > 0:
        print(f"program slot - uniform slot: {prog[2] - bern[2]:+.0f} "
              f"device operations, {prog[1] - bern[1]:+.4f} device ms (the "
              "program's inject draws no destinations; the scheduler "
              "adds its own)")


def run_phase14() -> dict:
    """The workload programs at the figures' size: each fabric's points
    through one ``run_all`` with one ``SimulatorCache``, against their
    goldens, and a program slot's costs.  Returns the launches summed
    over their main paths."""
    import torch
    phase("14. workload programs: the allreduce rows of Figures 5 (OFT) "
          "and 7 and a windowed All2All")
    total = dict.fromkeys(KERNELS, 0)
    groups = {}
    for point in golden_points(PHASE14_GOLDENS):
        exp = point[0]
        groups.setdefault((exp.network, exp.route), []).append(point)
    mrls_tables = mrls_exp = None
    for points in groups.values():
        counts, tables = run_shared(points)
        for k in total:
            total[k] += counts[k]
        exp = points[0][0]
        if exp.network.family == "mrls":
            mrls_tables, mrls_exp = tables, exp
        del tables
    print("the cost of a program slot on the Figure-5 MRLS, Polarized:")
    program_slot_costs(mrls_tables, mrls_exp)
    del mrls_tables
    torch.cuda.empty_cache()
    return total


def _differs(label: str, got: dict, want: dict) -> None:
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in want
                if got.get(k) != want.get(k)}
        raise AssertionError(f"{label} differs from the JAX reference: "
                             f"{diff}")


def replica_slot_costs(sim, exp, scalar: dict) -> None:
    """A uniform slot of ``exp``'s batched state (its replicas) on
    ``sim``, measured as :func:`breakdown` measures the scalar slot
    (100 slots into steady state, the host time over 50, the profile
    over 10; two batched slots under the sync debug mode first), beside
    ``scalar``, phase 6's scalar slot of the same fabric in this call:
    host ms a slot, replica-slots/s, device-busy ms, device operations,
    idle share, and each crossbar kernel's device time a launch."""
    from repro_torch.simulator.engine import Traffic
    tr = Traffic(exp.workload.pattern, load=exp.workload.load)
    reps = exp.replicas
    st = sim.make_batch_state(tr, exp.replica_seeds())
    sim.run_chunk(st, tr, 100)                  # into steady state
    no_sync(lambda: sim._step(st, tr), 2)
    print(f"2 slots of {reps} replicas under torch.cuda.set_sync_debug_mode"
          "('error'): the batched step makes no host synchronisation")
    ms = host_ms(lambda: sim._step(st, tr), 50)
    n_prof = 10
    _, rows = profile_slots(lambda: sim._step(st, tr), n_prof)
    busy_ms, ops = device_load(rows, n_prof)
    del st
    for r, c in ((1, scalar), (reps, {"ms": ms, "busy_ms": busy_ms,
                                      "ops": ops})):
        label = (f"R = {r} uniform slot (load {exp.workload.load}"
                 + (", phase 6)" if r == 1 else ")"))
        busy = (f"device busy {c['busy_ms']:.4f} ms in {c['ops']:.0f} "
                f"device operations, idle share "
                f"{100 * (1 - c['busy_ms'] / c['ms']):.1f}%"
                if c["busy_ms"] > 0 else "device time not measured")
        print(f"{label}: host {c['ms']:.4f} ms a slot = {1e3 / c['ms']:.2f} "
              f"slots/s = {r * 1e3 / c['ms']:.2f} replica-slots/s; {busy}")
    print(f"R = {reps} / R = 1: host ms {ms / scalar['ms']:.3f}x, "
          f"replica-slots/s {reps * scalar['ms'] / ms:.3f}x")
    for dev_us, count, k in rows:
        for nm in ("vc_prearb", "switch_arbitrate_rows"):
            if f"{nm}_kernel" in k:
                print(f"  {nm}: {dev_us / count:.3f} us a launch on the main "
                      f"path at R = {reps} ({count // n_prof} a slot)")


def run_phase15(scalar_slot: dict) -> dict:
    """Replicas on the card: the crossbar kernels with a replica axis,
    Figure 5's MRLS uniform row and Rabenseifner allreduce at the
    figure's 4 replicas against their goldens (replica 0 against the
    scalar goldens), their launches, and the cost of a batched slot
    beside phase 6's scalar one (``scalar_slot``).  Returns the launches
    summed over the two main-path runs."""
    import torch
    from repro_torch.api import Experiment, SimulatorCache, run, run_all
    from repro_torch.kernels.switch_arb import bench as arb_bench
    phase("15. replicas: Figure 5's MRLS row at the figure's 4 replicas")
    geo = arb_bench.geometry("fig5", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    arb_bench.run_replica_cases(geo, gen)
    arb_bench.time_replicas(geo, gen)
    del geo, gen
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    total = dict.fromkeys(KERNELS, 0)
    uniform = json.loads(REP_UNIFORM_GOLDEN.read_text())
    scalar = json.loads(FIG5_GOLDEN.read_text())
    allreduce = json.loads(REP_ALLREDUCE_GOLDEN.read_text())
    scalar_ar = json.loads(PROG_GOLDENS[0].read_text())
    exp = Experiment.from_dict(uniform["experiment"])
    exps = [Experiment.from_dict(g["experiment"]) for g in allreduce]
    assert all((e.network, e.route) == (exp.network, exp.route)
               for e in exps)
    timing = []
    with SimulatorCache() as cache, timed_runs(timing, peaks=True):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = cache.get(exp.network, exp.route)
        torch.cuda.synchronize()
        counts = read_counts()
        setup_peaks = (torch.cuda.max_memory_allocated(),
                       torch.cuda.max_memory_reserved())
        print(f"set-up of the Figure-5 simulator: {time.perf_counter() - t0:.3f}"
              f" s ({sim.tables.squarings} minplus_hops products); peak "
              f"device memory {setup_peaks[0]} bytes allocated, "
              f"{setup_peaks[1]} reserved")
        check_counts(counts, {**NO_LAUNCHES,
                              "minplus_hops": sim.tables.squarings},
                     "the simulator's set-up")

        # Figure 5's uniform row through run, 4 replicas in one run
        reset_counts()
        t0 = time.perf_counter()
        res = run(exp, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        rec = timing.pop()
        slots = exp.warm + exp.measure
        got = res.to_dict()
        print(f"{exp.name} x {exp.replicas} replicas: per replica "
              f"{got['per_replica']}; {rec['slots_run']} slots of "
              f"{exp.replicas} replicas in {rec['run_s']:.3f} s "
              f"({rec['slots_run'] / rec['run_s']:.2f} slots/s = "
              f"{exp.replicas * rec['slots_run'] / rec['run_s']:.2f} "
              f"replica-slots/s; {wall:.3f} s through run); peak device "
              f"memory of the run {rec['peak']} bytes allocated, "
              f"{rec['peak_reserved']} reserved")
        MEASURED[f"{exp.name} x {exp.replicas}"] = dict(
            exp=exp, peak=max(rec["peak"], setup_peaks[0]),
            peak_reserved=max(rec["peak_reserved"], setup_peaks[1]))
        _differs(exp.name, got, uniform)
        print(f"{exp.name}: Result equals {REP_UNIFORM_GOLDEN.name} field for"
              " field")
        for k in ("throughput", "avg_hops", "ejected", "pool_stall"):
            if got["per_replica"][k][0] != scalar[k]:
                raise AssertionError(f"replica 0's {k} is not the scalar "
                                     f"golden's: {got['per_replica'][k][0]}"
                                     f" != {scalar[k]}")
        print(f"replica 0 equals {FIG5_GOLDEN.name}'s scalar fields")
        if rec["slots_run"] != slots:
            raise AssertionError(f"{rec['slots_run']} steps for {slots} "
                                 "slots")
        check_counts(counts, expected_counts(exp, slots, 0),
                     f"the {exp.replicas}-replica uniform run")
        for k in total:
            total[k] += counts[k]

        # the allreduce as four seed-only experiments: run_all folds them
        reset_counts()
        t0 = time.perf_counter()
        results = run_all(exps, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if len(timing) != 1:
            raise AssertionError(f"run_all made {len(timing)} runs, not one "
                                 "batched run")
        rec = timing.pop()
        ran = rec["slots_run"]
        for res, want in zip(results, allreduce):
            got = res.to_dict()
            print(f"{res.name} seed {res.experiment.seed}: slots "
                  f"{res.slots}, completed {res.completed}, pool_stall "
                  f"{res.pool_stall}")
            _differs(f"{res.name} seed {res.experiment.seed}", got, want)
        print(f"the 4 unfolded Results equal {REP_ALLREDUCE_GOLDEN.name} "
              f"field for field; one batched run of {ran} steps in "
              f"{rec['run_s']:.3f} s ({ran / rec['run_s']:.2f} steps/s = "
              f"{len(exps) * ran / rec['run_s']:.2f} replica-steps/s; "
              f"{wall:.3f} s through run_all); peak device memory of the "
              f"run {rec['peak']} bytes")
        first = results[0].to_dict()
        for k in ("slots", "completed", "phase_slots", "pool_stall"):
            if first[k] != scalar_ar[k]:
                raise AssertionError(f"replica 0's {k} is not the scalar "
                                     f"golden's: {first[k]} != "
                                     f"{scalar_ar[k]}")
        print(f"replica 0 equals {PROG_GOLDENS[0].name}'s "
              f"({scalar_ar['slots']} slots)")
        check_counts(counts, {**NO_LAUNCHES,
                              "vc_prearb": (exp.route.speedup + 1) * ran,
                              "switch_arbitrate_rows": exp.route.speedup
                              * ran},
                     "the folded 4-seed allreduce")
        for k in total:
            total[k] += counts[k]

        print("the cost of a batched slot on the Figure-5 MRLS, Polarized:")
        replica_slot_costs(sim, exp, scalar_slot)
        del sim
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------- #
# open-loop serving (phase 16)
# ---------------------------------------------------------------------- #
def arrival_maps() -> None:
    """The arrival source's float32 maps on the card over their whole
    domains, bitwise against the CPU: each pareto batch size of the 2^23
    uniform draws, the diurnal rate at slots 0 .. 2^16, and glibc's
    ``sinf`` on 2^20 seeded floats of every exponent.  Also how far a
    direct ``pow`` on the card would part from the CPU's (the port's map
    does not use it)."""
    import numpy as np
    import torch
    from repro_torch.simulator import arrivals
    t0 = time.perf_counter()
    u_cpu = (torch.arange(arrivals.UNIFORM_STEPS, dtype=torch.int32)
             .to(torch.float32) * 2.0 ** -23)
    u = u_cpu.cuda()
    for alpha, cap in PARETO_MAPS:
        want = arrivals.pareto_batch(u_cpu, arrivals.pareto_thresholds(
            alpha, cap))
        got = arrivals.pareto_batch(u, arrivals.pareto_thresholds(
            alpha, cap, "cuda")).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"pareto batch map ({alpha}, {cap}) on the "
                                 "card differs from the CPU's")
        c, e = float(np.float32(1.0 - float(cap) ** -alpha)), float(
            np.float32(-1.0 / alpha))
        pows = [arrivals.fma_f32(-x, c, 1.0).pow(e) for x in (u, u_cpu)]
        n_pow = int((pows[0].cpu() != pows[1]).sum())
        n_batch = int((pows[0].floor().clamp(1, cap).cpu()
                       != pows[1].floor().clamp(1, cap)).sum())
        print(f"pareto (alpha {alpha}, cap {cap}): the batch sizes of all "
              f"2^23 draws equal the CPU's; a direct pow on the card would "
              f"differ from the CPU's at {n_pow} bases, {n_batch} batch "
              "sizes")
    del u, u_cpu, pows
    slots = torch.arange((1 << 16) + 1, dtype=torch.int32)
    for load, amp, period in DIURNAL_RATES:
        want = arrivals.diurnal_rate(slots, load, amp, period)
        got = arrivals.diurnal_rate(slots.cuda(), load, amp, period).cpu()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"diurnal rate ({load}, {amp}, {period}) "
                                 "on the card differs from the CPU's")
        plain = (load * (1.0 + amp * torch.sin(
            slots.cuda().float() * float(np.float32(2 * np.pi / period))))
                 ).cpu()
        print(f"diurnal (load {load}, amplitude {amp}, period {period}): "
              "the rate at slots 0 .. 2^16 equals the CPU's bit for bit; "
              f"torch.sin with separate roundings would differ at "
              f"{int((plain != want).sum())} slots")
    rng = np.random.default_rng(16)
    y = rng.integers(0x00800000, 0x7f800000, 1 << 20,
                     dtype=np.uint32).view(np.float32)
    y = torch.from_numpy(y.copy())
    if not torch.equal(arrivals.sinf(y.cuda()).cpu().view(torch.int32),
                       arrivals.sinf(y).view(torch.int32)):
        raise AssertionError("sinf on the card differs from the CPU's")
    print("sinf of 2^20 seeded floats (2^-126 .. 2^127) equals the CPU's; "
          f"the maps took {time.perf_counter() - t0:.3f} s")


@contextlib.contextmanager
def last_serving_state(last: dict):
    """Keep in ``last`` the simulator and final state of each scalar
    ``Simulator.run_serving``, for the conservation ledger."""
    from repro_torch.simulator.engine import Simulator
    saved = Simulator.run_serving

    def keep(self, *args, **kw):
        r = saved(self, *args, **kw)
        last.update(sim=self, state=r["state"])
        return r

    Simulator.run_serving = keep
    try:
        yield
    finally:
        Simulator.run_serving = saved


def ledger(sim, st, label: str) -> None:
    """``arrived == backlog + sum(msg_rem) + created`` on a final state
    on the card."""
    backlog = sim.arrival_backlog(st)
    arrived, pending, created = (int(st[k].sum()) for k in
                                 ("arrived", "msg_rem", "created"))
    print(f"{label}: ledger arrived {arrived} = backlog {backlog} + "
          f"pending {pending} + created {created}")
    if arrived != backlog + pending + created:
        raise AssertionError(f"{label}: the open-loop ledger does not close")


def arrival_slot_costs(sim, exps: dict, scalar: dict) -> None:
    """Two slots each of the pareto and the diurnal source under the sync
    debug mode; the host ms of a uniform, a poisson and a diurnal slot
    of the 1k MRLS at the diurnal point's load (5 slots in, over 15
    slots); and the diurnal slot's device ms, device operations and idle
    share from a profile of 5 slots, beside phase 6's
    uniform slot of the Figure-5 MRLS (``scalar``)."""
    from repro_torch.api.runner import _to_traffic
    from repro_torch.simulator.engine import Traffic
    for name in ("pareto", "diurnal"):
        exp = exps[name]
        tr = _to_traffic(exp)
        st = sim.make_batch_state(tr, [exp.seed])
        sim.run_chunk(st, tr, 4)
        no_sync(lambda: sim._step(st, tr), 2)
    print("2 pareto and 2 diurnal slots under torch.cuda.set_sync_debug_mode"
          "('error'): the arrival step makes no host synchronisation")
    load = exps["diurnal"].workload.load
    host = {}
    for label, tr in (("uniform", Traffic("uniform", load=load)),
                      ("poisson", Traffic("arrival", process="poisson",
                                          load=load)),
                      ("diurnal", _to_traffic(exps["diurnal"]))):
        st = sim.make_batch_state(tr, [0])
        sim.run_chunk(st, tr, 5)
        host[label] = host_ms(lambda: sim._step(st, tr), 15)
    print(f"host ms a slot at load {load}, {sim.S} endpoints (15 slots): "
          + ", ".join(f"{k} {v:.4f} ({1e3 / v:.2f} slots/s)"
                      for k, v in host.items()))
    _, rows = profile_slots(lambda: sim._step(st, tr), 5)
    busy_ms, ops = device_load(rows, 5)
    if busy_ms <= 0:
        print("diurnal slot: device time not measured (no device events)")
        return
    print(f"diurnal slot, profile of 5 slots: device busy "
          f"{busy_ms:.4f} ms in {ops:.0f} device operations, idle share "
          f"{100 * (1 - busy_ms / host['diurnal']):.1f}% of its "
          f"{host['diurnal']:.4f} ms; phase 6's Figure-5 uniform slot: "
          f"{scalar['ms']:.4f} ms, {scalar['busy_ms']:.4f} ms busy, "
          f"{scalar['ops']:.0f} operations ({ops - scalar['ops']:+.0f})")


def run_phase16(scalar_slot: dict) -> dict:
    """Open-loop serving on the two 1k-endpoint fabrics of
    ``examples/specs/serve_1k.json``: the float32 maps on the card, the
    four points against their goldens with their launches, the ledger,
    the sync check and the cost of an arrival slot.  Returns the
    launches summed over the main-path runs and the two set-ups."""
    import torch
    from repro_torch.api import Experiment, SimulatorCache, run
    from repro_torch.serving import ServingSpec, serve_sweep
    phase("16. open-loop serving on the 1k-endpoint MRLS and Fat-Tree")
    arrival_maps()
    total = dict.fromkeys(KERNELS, 0)
    sweep_golden = json.loads(SERVE_SWEEP_GOLDEN.read_text())
    spec = ServingSpec.from_dict(sweep_golden["spec"])
    goldens = [(json.loads(p.read_text()), p.name) for p in SERVE_GOLDENS]
    exps = [Experiment.from_dict(g["experiment"]) for g, _ in goldens]
    timing, last = [], {}
    with SimulatorCache() as cache, timed_runs(timing, peaks=True), \
            last_serving_state(last):
        for network, route in ((spec.network, spec.route),
                               (exps[0].network, exps[0].route)):
            reset_counts()
            t0 = time.perf_counter()
            sim = cache.get(network, route)
            torch.cuda.synchronize()
            counts = read_counts()
            print(f"{network.family} {network.param_dict()} under "
                  f"{route.policy}: N={sim.N} S={sim.S} P={sim.P}; set-up "
                  f"{time.perf_counter() - t0:.3f} s "
                  f"({sim.tables.squarings} minplus_hops products)")
            check_counts(counts, {**NO_LAUNCHES,
                                  "minplus_hops": sim.tables.squarings},
                         f"the {network.family} set-up")
            for k in total:
                total[k] += counts[k]

        # a. the MRLS poisson sweep with its request leg
        reset_counts()
        t0 = time.perf_counter()
        record = serve_sweep(spec, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ran = sum(r["slots_run"] for r in timing)
        for load, r in zip(spec.loads + ("request",), timing):
            print(f"  {spec.label()} @ {load}: {r['slots_run']} slots in "
                  f"{r['run_s']:.3f} s ({r['slots_run'] / r['run_s']:.2f} "
                  f"slots/s); peak device memory of the run {r['peak']} "
                  "bytes")
        timing.clear()
        for p in record["points"]:
            print(f"  load {p['load']}: offered {p['offered']!r} delivered "
                  f"{p['delivered']!r} dropped {p['dropped']} pool_stall "
                  f"{p['pool_stall']} p50/p99/p999/p9999 {p['p50']}/"
                  f"{p['p99']}/{p['p999']}/{p['p9999']}")
        print(f"  saturation {record['saturation']}; request "
              f"{record['request']}")
        _differs(spec.label(), json.loads(json.dumps(record)), sweep_golden)
        print(f"serve_sweep of {spec.label()}: {wall:.3f} s; the SLO record "
              f"equals {SERVE_SWEEP_GOLDEN.name} field for field")
        check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * ran,
                              "switch_arbitrate_rows": 2 * ran},
                     f"the sweep ({ran} steps)")
        for k in total:
            total[k] += counts[k]

        # b-d. Fat-Tree poisson at 4 replicas, MRLS pareto and diurnal
        for exp, (golden, fname) in zip(exps, goldens):
            last.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reset_counts()
            res = run(exp, cache=cache)
            torch.cuda.synchronize()
            counts = read_counts()
            rec = timing.pop()
            ran = rec["slots_run"]
            got = res.to_dict()
            per = (f"; per replica {got['per_replica']}"
                   if exp.replicas > 1 else "")
            print(f"{exp.name} x {exp.replicas}: offered {res.offered!r} "
                  f"delivered {res.throughput!r} dropped {res.dropped} "
                  f"pool_stall {res.pool_stall} latency {res.latency}{per}; "
                  f"{ran} slots in {rec['run_s']:.3f} s "
                  f"({ran / rec['run_s']:.2f} slots/s = "
                  f"{exp.replicas * ran / rec['run_s']:.2f} replica-slots/s)"
                  f"; peak device memory of the run {rec['peak']} bytes "
                  f"allocated, {rec['peak_reserved']} reserved (the two 1k "
                  "simulators held)")
            if exp.workload.pattern == "pareto":
                MEASURED[exp.name] = dict(
                    exp=exp, peak=rec["peak"],
                    peak_reserved=rec["peak_reserved"])
            _differs(exp.name, got, golden)
            print(f"{exp.name}: Result equals {fname} field for field")
            check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * ran,
                                  "switch_arbitrate_rows": 2 * ran},
                         f"the {exp.name} run")
            for k in total:
                total[k] += counts[k]
            if exp.replicas == 1:
                ledger(last["sim"], last["state"], exp.name)
        last.clear()
        print("the cost of an arrival slot on the 1k MRLS, Polarized:")
        arrival_slot_costs(cache.get(spec.network, spec.route),
                           {e.workload.pattern: e for e in exps[1:]},
                           scalar_slot)
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------- #
# failures (phase 17)
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def delta_log(log: list):
    """Append to ``log`` every ``RoutingTables.apply_failures`` call as
    ``(tables, delta, effective adjacency after it, seconds)``, the card
    synchronised around it; on a tables object's first call, keep a copy
    of its pristine rows in ``tables._pristine`` first."""
    import torch
    from repro_torch.core.routing import RoutingTables
    saved = RoutingTables.apply_failures

    def logged(self, *args, **kw):
        if not hasattr(self, "_pristine"):
            self._pristine = self.dist_leaf.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        delta = saved(self, *args, **kw)
        torch.cuda.synchronize()
        log.append((self, delta, self.effective_nbrs(),
                    time.perf_counter() - t0))
        return delta

    RoutingTables.apply_failures = logged
    try:
        yield
    finally:
        RoutingTables.apply_failures = saved


def check_deltas(log: list, label: str) -> int:
    """Each logged delta's distance rows bitwise the host BFS from its
    leaves over the same effective adjacency (``UNREACHABLE`` where cut
    off), the mask words of its first 64 rows the host's numpy packing of
    those rows, and each tables object back to its pristine rows with no
    dead element.  Returns the deltas' ``minplus_hops`` products."""
    import numpy as np
    import torch
    from repro_torch.core.routing import (UNREACHABLE, _pack_mask_block,
                                          bfs_distances)
    products, seen = 0, []
    for tables, delta, eff, sec in log:
        topo = tables.topo
        k = delta.n_affected
        products += delta.products
        cut = 0
        if k:
            bfs = bfs_distances(topo, topo.leaf_ids[delta.leaf_rows],
                                nbrs=eff)
            want = np.where(bfs < 0, UNREACHABLE, bfs).astype(np.int16)
            got = delta.dist_rows.cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: a delta's rows differ from "
                                     "the host BFS")
            cut = int((want == UNREACHABLE).sum())
            valid = topo.nbrs >= 0
            m, a = _pack_mask_block(want[:64], topo.nbrs, valid,
                                    np.where(valid, topo.nbrs, 0))
            if not (np.array_equal(delta.min_rows[:64].cpu().numpy().view(
                    np.uint32), m) and np.array_equal(
                    delta.away_rows[:64].cpu().numpy().view(np.uint32), a)):
                raise AssertionError(f"{label}: a delta's mask words differ "
                                     "from the host packing")
        print(f"  delta: {k} of {tables.dist_leaf.shape[0]} leaf rows "
              f"rebuilt, {delta.products} minplus_hops products, {cut} "
              f"entries UNREACHABLE, "
              f"{int((~delta.link_up & (topo.nbrs >= 0)).sum())} dead "
              f"ports, {sec:.4f} s; rows equal the host BFS")
        if tables not in seen:
            seen.append(tables)
    for tables in seen:
        if not (torch.equal(tables.dist_leaf, tables._pristine)
                and not tables.dead_ports.any()
                and not tables.dead_switches.any()):
            raise AssertionError(f"{label}: the tables were not restored")
    print(f"{label}: {len(log)} deltas checked; the tables are bitwise "
          "their pristine rows again")
    return products


@contextlib.contextmanager
def last_resilience_state(last: dict):
    """Keep in ``last`` the simulator and final state of each
    ``Simulator.run_resilience``."""
    from repro_torch.simulator.engine import Simulator
    saved = Simulator.run_resilience

    def keep(self, *args, **kw):
        r = saved(self, *args, **kw)
        last.setdefault("runs", []).append((self, r["state"]))
        return r

    Simulator.run_resilience = keep
    try:
        yield
    finally:
        Simulator.run_resilience = saved


def pool_ledger(sim, st, label: str) -> None:
    """``fl_len`` plus the packets in the input, output and NIC queues is
    the pool, on a final state on the card."""
    free = int(st["fl_len"])
    queued = [int(st[k].sum()) for k in ("qlen", "oq_len", "eq_len")]
    print(f"{label}: pool ledger {free} free + {queued[0]} input + "
          f"{queued[1]} output + {queued[2]} NIC = {free + sum(queued)} "
          f"(pool {sim.pool}); fail_drop of the run {int(st['fail_drop'])}")
    if free + sum(queued) != sim.pool:
        raise AssertionError(f"{label}: the pool ledger does not close")


def delta_seconds(topo, events, label: str, reps: int = 3) -> None:
    """A full ``build_tables`` on the card beside the delta rebuild of
    ``events`` going down and back up on its tables, best of ``reps``,
    the card synchronised around each."""
    import torch
    from repro_torch.core import build_tables

    def best(fn):
        out, t = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        return out, min(t)

    tables, full_s = best(lambda: build_tables(topo, device="cuda"))
    pristine = tables.dist_leaf.clone()
    down_s, up_s = [], []
    for _ in range(reps):
        for t, kw in ((down_s, {"down": events}), (up_s, {"up": events})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = tables.apply_failures(**kw)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
            k, prods = d.n_affected, d.products
            if "down" in kw:
                kd, pd = k, prods
    if not torch.equal(tables.dist_leaf, pristine):
        raise AssertionError(f"{label}: delta restore is not exact")
    print(f"{label}: full build_tables {full_s:.4f} s ({tables.squarings} "
          f"products); delta down {min(down_s):.4f} s ({kd} rows, {pd} "
          f"products), back up {min(up_s):.4f} s ({k} rows, {prods} "
          f"products); delta / full {min(down_s) / full_s:.2f} (best of "
          f"{reps})")


def armed_slot_costs(sim, exps: dict, scalar: dict) -> None:
    """Two armed slots of each of polarized, degraded and ugal (with the
    schedule's events down in the state's tables) under the sync debug
    mode; then the host ms of an armed degraded slot of the 1k MRLS with
    5 % of its links down beside the same fabric's pristine slot (5 slots
    in; 10 timed slots each in the order pristine, armed, armed,
    pristine), and both slots' device ms and operations from a profile
    of 5 slots."""
    import torch
    from repro_torch.api.runner import _to_traffic
    from repro_torch.core import FailureSchedule, canonical_link_ids
    from repro_torch.simulator.engine import Simulator
    for policy, (s, exp) in exps.items():
        tr = _to_traffic(exp)
        events = [e for e in s.failures.events if e.kind == "link"] or \
            list(s.failures.events)
        st = s.make_batch_state(tr, [exp.seed])
        s.run_chunk(st, tr, 4)
        s.update_tables(st, s.tables.apply_failures(down=events))
        no_sync(lambda: s._step(st, tr), 2)
        s.tables.apply_failures(up=events)
        print(f"2 armed {policy} slots ({len(events)} events down) under "
              "torch.cuda.set_sync_debug_mode('error'): no host sync")
    tables = sim.tables
    topo = tables.topo
    k = round(0.05 * len(canonical_link_ids(topo)))
    sched = FailureSchedule.random_links(topo, k, down_slot=0, seed=0)
    armed = Simulator(tables, sim.cfg, sched, device="cuda")
    tr = _to_traffic(exps["degraded"][1])
    runs = {}
    for label, s in (("pristine", sim), ("armed", armed)):
        st = s.make_batch_state(tr, [0])
        if s is armed:
            s.update_tables(st, tables.apply_failures(down=sched.events))
            tables.apply_failures(up=sched.events)
        s.run_chunk(st, tr, 5)
        runs[label] = (s, st)
    host = {"pristine": [], "armed": []}
    for label in ("pristine", "armed", "armed", "pristine"):
        s, st = runs[label]
        host[label].append(host_ms(lambda: s._step(st, tr), 10))
    cost = {}
    for label, (s, st) in runs.items():
        _, rows = profile_slots(lambda: s._step(st, tr), 5)
        cost[label] = (sum(host[label]) / 2,) + device_load(rows, 5)
    print(f"host ms of the 10-slot runs, pristine / armed: "
          f"{[round(x, 4) for x in host['pristine']]} / "
          f"{[round(x, 4) for x in host['armed']]}")
    for label, (ms, busy, ops) in cost.items():
        print(f"{label} degraded slot of {topo.n_endpoints} endpoints "
              f"({k} links down in the armed one): host {ms:.4f} ms "
              f"({1e3 / ms:.2f} slots/s); device busy {busy:.4f} ms in "
              f"{ops:.0f} operations, idle share "
              f"{100 * (1 - busy / ms):.1f}%" if busy > 0 else
              f"{label}: host {ms:.4f} ms; device time not measured")
    print(f"armed - pristine: {cost['armed'][2] - cost['pristine'][2]:+.0f} "
          f"operations; phase 6's Figure-5 uniform slot {scalar['ms']:.4f} "
          f"ms, {scalar['ops']:.0f} operations")


def run_phase17(scalar_slot: dict) -> dict:
    """Failures: the 1k MRLS degradation sweep, the Figure-5 MRLS drop
    and restore, the Fat-Tree switch event and the Dragonfly's UGAL
    ladder against their goldens, with their launches (the build's and
    each delta's ``minplus_hops`` products), each delta's rows against
    the host BFS, the tables' restore, the pool ledger, the sync check,
    the delta rebuild's seconds and an armed slot's cost.  Returns the
    launches summed over the main-path runs and the set-ups."""
    import torch
    from repro_torch.api import (DegradeSpec, Experiment, SimulatorCache,
                                 degrade_sweep, run)
    phase("17. failures: degradation curve, drop and restore, switch event, "
          "UGAL ladder")
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    timing, last, log = [], {}, []
    armed = {}
    with SimulatorCache() as cache, timed_runs(timing, peaks=True), \
            last_resilience_state(last), delta_log(log):
        # a. the degradation sweep: one simulator armed with the largest
        # schedule, built inside degrade_sweep
        golden = json.loads(FAULT_SWEEP_GOLDEN.read_text())
        spec = DegradeSpec.from_dict(golden["spec"])
        reset_counts()
        t0 = time.perf_counter()
        t_phase = t0
        record = degrade_sweep(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        tables = last["runs"][0][0].tables
        for p, r in zip(record["points"], timing):
            print(f"  rate {p['rate']}: {p['n_links_down']} links down, "
                  f"delivered {p['delivered']!r} retention "
                  f"{p['retention']!r} p50/p99 {p['p50']}/{p['p99']} "
                  f"fail_drop {p['fail_drop']}; {r['slots_run']} slots in "
                  f"{r['run_s']:.3f} s ({r['slots_run'] / r['run_s']:.2f} "
                  f"slots/s); peak device memory {r['peak']} bytes")
        ran = sum(r["slots_run"] for r in timing)
        timing.clear()
        _differs(spec.base.label(), json.loads(json.dumps(record)),
                 golden["record"])
        print(f"degrade_sweep of {spec.base.label()}: {wall:.3f} s; the "
              f"record equals {FAULT_SWEEP_GOLDEN.name} field for field")
        products = check_deltas(log, spec.base.label())
        check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * ran,
                              "switch_arbitrate_rows": 2 * ran,
                              "minplus_hops": tables.squarings + products},
                     f"the sweep ({ran} steps, the build's "
                     f"{tables.squarings} + the deltas' {products} "
                     "products)")
        add(counts)
        for sim, st in last.pop("runs"):
            pool_ledger(sim, st, spec.base.label())
        log.clear()

        # b-d. the Figure-5 drop and restore, the Fat-Tree switch event
        # and the Dragonfly's UGAL ladder, each through run
        goldens = [(json.loads(p.read_text()), p.name) for p in FAULT_GOLDENS]
        for golden, fname in goldens:
            exp = Experiment.from_dict(golden["experiment"])
            reset_counts()
            t0 = time.perf_counter()
            sim = cache.get(exp.network, exp.route)
            torch.cuda.synchronize()
            counts = read_counts()
            print(f"{exp.name}: {exp.network.family} "
                  f"{exp.network.param_dict()} under {exp.route.policy}: "
                  f"N={sim.N} S={sim.S} P={sim.P}, "
                  f"{len(exp.network.failures)} events "
                  f"({exp.network.failures.policy}); set-up "
                  f"{time.perf_counter() - t0:.3f} s "
                  f"({sim.tables.squarings} minplus_hops products)")
            check_counts(counts, {**NO_LAUNCHES,
                                  "minplus_hops": sim.tables.squarings},
                         f"the {exp.name} set-up")
            add(counts)
            reset_counts()
            res = run(exp, cache=cache)
            torch.cuda.synchronize()
            counts = read_counts()
            rec = timing.pop()
            ran = rec["slots_run"]
            print(f"{exp.name}: throughput {res.throughput!r} avg_hops "
                  f"{res.avg_hops!r} ejected {res.ejected} fail_drop "
                  f"{res.fail_drop} latency {res.latency}; {ran} slots "
                  f"in {rec['run_s']:.3f} s ({ran / rec['run_s']:.2f} "
                  f"slots/s); peak device memory of the run "
                  f"{rec['peak']} bytes")
            _differs(exp.name, res.to_dict(), golden)
            print(f"{exp.name}: Result equals {fname} field for field")
            products = check_deltas(log, exp.name)
            log.clear()
            check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * ran,
                                  "switch_arbitrate_rows": 2 * ran,
                                  "minplus_hops": products},
                         f"the {exp.name} run ({ran} steps, the "
                         f"deltas' {products} products)")
            add(counts)
            (run_sim, st), = last.pop("runs")
            pool_ledger(run_sim, st, exp.name)
            armed[exp.route.policy] = (sim, exp)
    t_runs = time.perf_counter()

    # the delta rebuild beside a full build, at the Figure-5 1 % set and
    # the Fat-Tree switch event; an armed slot's cost (outside the counted
    # runs and the logging wrapper)
    for policy in ("polarized", "degraded"):
        sim, exp = armed[policy]
        delta_seconds(sim.tables.topo, exp.network.failures.events,
                      exp.name)
    t_delta = time.perf_counter()
    with SimulatorCache() as cache:
        armed_slot_costs(cache.get(spec.base.network, spec.base.route),
                         armed, scalar_slot)
    del armed
    print(f"phase 17 parts: the four points with their checks "
          f"{t_runs - t_phase:.3f} s, delta timings "
          f"{t_delta - t_runs:.3f} s, sync checks and slot costs "
          f"{time.perf_counter() - t_delta:.3f} s")
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------- #
# the resumable runtime (phase 18)
# ---------------------------------------------------------------------- #
class KillAtSnapshot:
    """``Supervisor(popen=...)``: starts each attempt, records at its
    start the latest snapshot in ``ckpt`` and whether ``result.json``
    exists, and watches ``ckpt`` from a thread, noting when each new
    snapshot appears; the first attempt is SIGKILLed once ``n`` new
    snapshots have appeared."""

    def __init__(self, ckpt: Path, n: int, log: Path):
        self.ckpt, self.n, self.log = ckpt, n, log
        self.starts, self.seen, self.threads = [], [], []

    def _steps(self) -> set:
        return ({p.name for p in self.ckpt.glob("step_*")}
                if self.ckpt.exists() else set())

    def __call__(self, argv, **kw):
        before = self._steps()
        self.starts.append((max((int(s[5:]) for s in before), default=None),
                            (self.ckpt / "result.json").exists()))
        seen = []
        self.seen.append(seen)
        kill = len(self.starts) == 1
        with open(self.log, "a") as out:
            t0 = time.perf_counter()
            proc = subprocess.Popen(argv, stdout=out,
                                    stderr=subprocess.STDOUT, **kw)

        def watch():
            known = set(before)
            while proc.poll() is None:
                new = self._steps() - known
                for name in sorted(new):
                    seen.append((int(name[5:]), time.perf_counter() - t0))
                known |= new
                if kill and len(seen) >= self.n:
                    proc.send_signal(signal.SIGKILL)
                    return
                time.sleep(0.02)

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        self.threads.append(t)
        return proc


def snapshot_cost(ckpt: Path, label: str) -> None:
    """The bytes of the latest snapshot in ``ckpt`` and the seconds to
    take it again from the card: its arrays as card tensors, copied to
    the host, then written as ``npz`` (best of 3)."""
    import numpy as np
    import torch
    from repro_torch.checkpointing import Checkpointer
    step = Checkpointer(str(ckpt)).latest_step()
    npz = ckpt / f"step_{step:010d}" / "arrays.npz"
    with np.load(npz) as data:
        tree = {k: torch.as_tensor(data[k]).cuda() for k in data.files}
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree.values())
    scratch = Checkpointer(str(CKPT_ROOT / "cost"), keep=1)
    d2h, total = [], []
    for i in range(3):
        t0 = time.perf_counter()
        host = {k: t.to("cpu", copy=True) for k, t in tree.items()}
        d2h.append(time.perf_counter() - t0)
        del host
        t0 = time.perf_counter()
        scratch.save(i + 1, tree)
        total.append(time.perf_counter() - t0)
    print(f"{label} snapshot: {len(tree)} arrays, {n_bytes} bytes "
          f"({npz.stat().st_size} bytes of npz); device to host "
          f"{min(d2h):.4f} s, save (device to host + npz write) "
          f"{min(total):.4f} s, best of 3")


def kill_and_resume() -> tuple:
    """Point A: the Figure-5 allreduce through the CLI under the
    supervisor, killed at its second snapshot and resumed by the retry;
    ``result.json`` against the golden.  Returns (the checkpoint
    directory, the golden)."""
    from repro_torch.runtime.fault_tolerance import BackoffPolicy
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
    golden = json.loads(KILL_GOLDEN.read_text())
    ckpt, spec, log = CKPT_ROOT / "a", CKPT_ROOT / "a.json", \
        CKPT_ROOT / "a.log"
    spec.write_text(json.dumps(golden["experiment"]))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    argv = [sys.executable, "-m", "repro_torch.api", "run", str(spec),
            "--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
    popen = KillAtSnapshot(ckpt, 2, log)
    sup = Supervisor(SupervisorConfig(timeout_s=300, max_retries=2,
                                      poll_interval_s=0.05,
                                      backoff=BackoffPolicy(base_s=0.0)),
                     popen=popen)
    res = sup.run(argv, cwd=str(ROOT), env=env)
    for t in popen.threads:
        t.join(timeout=60)
        if t.is_alive():
            raise AssertionError("a snapshot watcher outlived its child")
    for i, (att, start, seen) in enumerate(zip(res.attempts, popen.starts,
                                               popen.seen)):
        seg = ([b - a for (_, a), (_, b) in zip(seen, seen[1:])]
               if len(seen) > 1 else [])
        mean = sum(seg) / len(seg) if seg else float("nan")
        first = seen[0][1] if seen else float("nan")
        print(f"attempt {i}: rc {att.returncode}, {att.wall_s:.3f} s, peak "
              f"RSS {att.peak_rss_bytes} bytes; started at snapshot "
              f"{start[0]} (result.json {start[1]}); snapshots "
              f"{[s for s, _ in seen]} seen at "
              f"{[round(t, 3) for _, t in seen]} s after Popen; a segment "
              f"(2 chunks, the mean gap between snapshots) {mean:.3f} s; "
              f"the first snapshot less one mean segment (derived start-up) "
              f"{first - mean:.3f} s")
    if not (res.ok and len(res.attempts) == 2
            and res.attempts[0].returncode == -signal.SIGKILL
            and popen.starts[0] == (None, False)
            and popen.starts[1][0] is not None
            and popen.starts[1][0] >= 2 and not popen.starts[1][1]):
        print(log.read_text()[-4000:])
        raise AssertionError(f"kill and resume: {res.to_dict()}, starts "
                             f"{popen.starts}")
    got = json.loads((ckpt / "result.json").read_text())
    _differs("the resumed allreduce", got, golden)
    print(f"result.json equals {KILL_GOLDEN.name} field for field")
    return ckpt, golden


def resume_window(scalar_slot: dict) -> dict:
    """Point B: the 1k pareto serving point through ``run_resumable`` in
    this process, then cut back to its cursor-192 snapshot and resumed;
    both against the golden, with their launches.  Returns the launches
    of the set-up and both runs."""
    import torch
    from repro_torch.api import (Experiment, SimulatorCache, resume,
                                 run_resumable)
    from repro_torch.checkpointing import Checkpointer
    from repro_torch.simulator.engine import Simulator
    golden = json.loads(RESUME_GOLDEN.read_text())
    exp = Experiment.from_dict(golden["experiment"])
    ckpt = CKPT_ROOT / "b"
    total = dict.fromkeys(KERNELS, 0)
    steps, chunks, saves = [0], [], []
    saved = {name: getattr(cls, name) for cls, name in (
        (Simulator, "_step"), (Simulator, "run_chunk"),
        (Checkpointer, "save"))}

    def step(self, *a, **kw):
        steps[0] += 1
        return saved["_step"](self, *a, **kw)

    def run_chunk(self, st, traffic, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved["run_chunk"](self, st, traffic, n)
        torch.cuda.synchronize()
        chunks.append((n, time.perf_counter() - t0))
        return out

    def save(self, *a, **kw):
        t0 = time.perf_counter()
        saved["save"](self, *a, **kw)
        saves.append(time.perf_counter() - t0)

    Simulator._step, Simulator.run_chunk, Checkpointer.save = \
        step, run_chunk, save
    try:
        with SimulatorCache() as cache:
            reset_counts()
            sim = cache.get(exp.network, exp.route)
            torch.cuda.synchronize()
            counts = read_counts()
            check_counts(counts, {**NO_LAUNCHES,
                                  "minplus_hops": sim.tables.squarings},
                         "the 1k MRLS set-up")
            for k in total:
                total[k] += counts[k]
            for label in ("run_resumable", "resume from cursor 192"):
                steps[0] = 0
                chunks.clear()
                saves.clear()
                reset_counts()
                t0 = time.perf_counter()
                res = (run_resumable(exp, str(ckpt), every=64, keep=8,
                                     cache=cache)
                       if label == "run_resumable"
                       else resume(str(ckpt), every=64, cache=cache))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
                _differs(f"{exp.name} through {label}", res.to_dict(),
                         golden)
                run_s = sum(t for _, t in chunks)
                latest = Checkpointer(str(ckpt)).latest_step()
                npz = ckpt / f"step_{latest:010d}" / "arrays.npz"
                print(f"{exp.name} through {label}: equals "
                      f"{RESUME_GOLDEN.name}; {steps[0]} steps in "
                      f"{len(chunks)} segments, {wall:.3f} s "
                      f"({run_s:.3f} s stepping, "
                      f"{1e3 * run_s / max(steps[0], 1):.4f} ms a slot; "
                      f"phase 6's Figure-5 slot {scalar_slot['ms']} ms); "
                      f"segments {[round(t, 3) for _, t in chunks]} s; "
                      f"{len(saves)} snapshots of {npz.stat().st_size} "
                      f"npz bytes, {[round(t, 4) for t in saves]} s each")
                check_counts(counts, {**NO_LAUNCHES,
                                      "vc_prearb": 3 * steps[0],
                                      "switch_arbitrate_rows": 2 * steps[0]},
                             f"{label} ({steps[0]} steps)")
                for k in total:
                    total[k] += counts[k]
                if label == "run_resumable":
                    if steps[0] != exp.warm + exp.measure:
                        raise AssertionError(f"{steps[0]} steps")
                    (ckpt / "result.json").unlink()
                    kept, cut = [], []
                    for d in sorted(ckpt.glob("step_*")):
                        cursor = json.loads(
                            (d / "meta.json").read_text())["cursor"]
                        if cursor > 192:
                            shutil.rmtree(d)
                            cut.append(d.name)
                        else:
                            kept.append(cursor)
                    if kept[-1:] != [192] or not cut:
                        raise AssertionError(f"no cursor-192 snapshot to "
                                             f"resume from: kept {kept}")
                    print(f"cut back to cursor 192: deleted result.json and "
                          f"{cut}")
                elif steps[0] != exp.warm + exp.measure - 192:
                    raise AssertionError(f"the resume ran {steps[0]} steps")
    finally:
        Simulator._step, Simulator.run_chunk, Checkpointer.save = (
            saved["_step"], saved["run_chunk"], saved["save"])
    snapshot_cost(ckpt, "1k serving")
    return total


def resume_cli(ckpt: Path, golden: dict) -> dict:
    """``python -m repro_torch.api resume`` through the CLI's ``main`` in
    this process: point A's finished directory cut back to its oldest
    kept snapshot (``result.json`` and the later snapshots deleted),
    resumed on the card to the same final segment, its printed record
    against the golden.  Returns its launches."""
    import contextlib
    import io
    import torch
    from repro_torch.api.__main__ import main
    from repro_torch.checkpointing import Checkpointer
    from repro_torch.simulator.engine import Simulator
    (ckpt / "result.json").unlink()
    kept = sorted(int(d.name[5:]) for d in ckpt.glob("step_*"))
    if len(kept) < 2:
        raise AssertionError(f"{ckpt.name} keeps snapshots {kept}: none "
                             f"to cut back to")
    for step in kept[1:]:
        shutil.rmtree(ckpt / f"step_{step:010d}")
    sims, steps = {}, [0]
    saved = Simulator._step

    def counted(self, *a, **kw):
        sims[id(self)] = self
        steps[0] += 1
        return saved(self, *a, **kw)

    out = io.StringIO()
    Simulator._step = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main(["resume", str(ckpt), "--ckpt-every", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        Simulator._step = saved
    if rc or not steps[0] or \
            Checkpointer(str(ckpt)).latest_step() != kept[-1]:
        raise AssertionError(f"resume {ckpt.name}: rc {rc}, {steps[0]} "
                             f"steps, kept {kept}")
    _differs("resume's record", json.loads(out.getvalue()), golden)
    check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * steps[0],
                          "switch_arbitrate_rows": 2 * steps[0],
                          "minplus_hops": sum(s.tables.squarings
                                              for s in sims.values())},
                 f"resume {ckpt.name} ({steps[0]} steps)")
    print(f"python -m repro_torch.api resume {ckpt.name} (its main, in "
          f"process) from snapshot {kept[0]} to {kept[-1]}: {steps[0]} "
          f"steps, {wall:.3f} s with the fabric's set-up; its record "
          f"equals {KILL_GOLDEN.name}")
    return counts


def run_phase18(scalar_slot: dict) -> dict:
    """The resumable runtime: a SIGKILLed Figure-5 allreduce resumed by
    the supervisor's retry, a 1k serving window cut back and resumed in
    process, and the allreduce cut back and resumed through the CLI's
    ``resume``, each against its golden.  Returns the in-process
    launches."""
    import torch
    phase("18. resumable runtime: a SIGKILLed Figure-5 allreduce and a "
          "resumed 1k serving window")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        ckpt, golden = kill_and_resume()
        t1 = time.perf_counter()
        total = resume_window(scalar_slot)
        t2 = time.perf_counter()
        for k, n in resume_cli(ckpt, golden).items():
            total[k] += n
        t3 = time.perf_counter()
        snapshot_cost(ckpt, "Figure-5 program")
        print(f"phase 18 parts: kill and resume {t1 - t0:.3f} s, the "
              f"resumed window {t2 - t1:.3f} s, the CLI's resume "
              f"{t3 - t2:.3f} s, snapshot costs "
              f"{time.perf_counter() - t3:.3f} s")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------- #
# memory, admission and search (phase 19)
# ---------------------------------------------------------------------- #
def hold_model(label: str, exp, peak: int, peak_reserved: int) -> None:
    """``device_peak_bytes(exp)`` beside a run's measured peaks: never
    below the reserved peak, and at most ``MODEL_OVER`` times it at
    ``MODEL_OVER_FROM`` endpoints and above."""
    from repro_torch.api.admission import device_bytes
    est = device_bytes(exp, "cuda")
    pred, S = est["peak_bytes"], est["n_endpoints"]
    ratio = pred / peak_reserved
    # what the run's allocated peak leaves for the step transients, per
    # requester-port pair (the model's STEP_* coefficients), and the
    # allocator's reserve over the allocated peak (ALLOCATOR_*)
    pairs = (peak - est["resident_bytes"]) / est["n_port_rows"]
    FIT_READINGS[label] = pairs
    print(f"  {label} (S={S}, R={est['replicas']}): predicted "
          f"{pred} bytes; measured {peak} allocated, {peak_reserved} "
          f"reserved; predicted / reserved {ratio:.3f} (model terms: "
          f"build {est['build_bytes']}, resident {est['resident_bytes']}, "
          f"transients {est['transient_bytes']}); allocated peak less the "
          f"model's resident bytes: {pairs:.2f} bytes a requester-port "
          f"pair ({pairs / est['replicas']:.2f} a replica); reserved / "
          f"allocated {peak_reserved / peak:.3f}")
    if pred < peak_reserved:
        raise AssertionError(f"{label}: the model predicts {pred} bytes, "
                             f"below the reserved peak {peak_reserved}")
    if S >= MODEL_OVER_FROM and ratio > MODEL_OVER:
        raise AssertionError(f"{label}: the model predicts {ratio:.3f}x "
                             f"the reserved peak (at most {MODEL_OVER}x)")


# the bytes a requester-port pair that hold_model reads off each run
FIT_READINGS = {}


def fit_step_bytes() -> None:
    """The line ``a R + b`` through the Figure-5 MRLS runs' readings at
    one and four replicas, printed beside the model's
    ``STEP_BYTES_PER_PORT_ROW`` and ``STEP_SHARED_BYTES_PER_PORT_ROW``,
    which were fitted to these readings."""
    from repro_torch.api import admission
    one = FIT_READINGS.get("fig5.mrls_u18")
    four = FIT_READINGS.get("fig5.mrls_u18.pol.uniform x 4")
    if one is None or four is None:
        print("step fit: the Figure-5 runs at R = 1 and 4 were not measured")
        return
    a = (four - one) / 3
    print(f"step fit from this run: {a:.2f} R + {one - a:.2f} bytes a "
          f"requester-port pair (the model: "
          f"{admission.STEP_BYTES_PER_PORT_ROW} R + "
          f"{admission.STEP_SHARED_BYTES_PER_PORT_ROW})")


def refuse_ft50() -> None:
    """The 100k Fat-Tree All2All at the smallest replica count the model
    prices over the card's budget: ``run`` refuses it with nothing
    allocated and no ``minplus_hops`` launch; ``mode="warn"`` admits
    it (not run)."""
    import dataclasses
    import torch
    from repro_torch.api import AdmissionError, Experiment, run
    from repro_torch.api.admission import (check_admission,
                                           device_budget_bytes,
                                           device_peak_bytes)
    exp = Experiment.from_dict(json.loads(
        A2A_GOLDENS["fig6.ft50"].read_text())["experiment"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    budget = device_budget_bytes("cuda")
    reps = 1
    while device_peak_bytes(dataclasses.replace(exp, replicas=reps),
                            "cuda") <= budget:
        reps += 1
    big = dataclasses.replace(exp, replicas=reps)
    below = device_peak_bytes(dataclasses.replace(exp, replicas=reps - 1),
                              "cuda")
    print(f"{exp.name}: the card's budget {budget} bytes (free + cached "
          f"unused); R = {reps - 1} predicts {below} bytes, R = {reps} "
          f"{device_peak_bytes(big, 'cuda')}: the smallest refused R is "
          f"{reps}")
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    try:
        run(big, device="cuda")
    except AdmissionError as e:
        msg = str(e)
    else:
        raise AssertionError(f"run admitted {exp.name} at R = {reps}")
    torch.cuda.synchronize()
    counts = read_counts()
    after = torch.cuda.memory_allocated()
    print(f"run refused it in {time.perf_counter() - t0:.3f} s: "
          f"AdmissionError: {msg}")
    if after != held:
        raise AssertionError(f"the refused run allocated {after - held} "
                             "bytes")
    print(f"memory_allocated {after} bytes before and after the refusal")
    check_counts(counts, NO_LAUNCHES, "the refused run")
    decision = check_admission(big, mode="warn", device="cuda")
    if not decision.admitted:
        raise AssertionError(f"mode='warn' refused: {decision}")
    print(f"check_admission(mode='warn') admits it: action "
          f"{decision.action!r}, predicted {decision.predicted_bytes} "
          f"bytes, budget {decision.budget_bytes} (not run)")


@contextlib.contextmanager
def search_runs(log: list, products: list):
    """Around ``repro_torch.search``: each candidate run's stage, seconds
    (set-up and run), steps and peak device bytes (the cache emptied
    before it; the other candidates' simulators stay held) into ``log``,
    and every table build's ``minplus_hops`` products into
    ``products``."""
    import torch
    from repro_torch.core import routing
    from repro_torch.search import loop
    saved_run, saved_hops = loop.run, routing.hop_distances
    timing = []

    def run(exp, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = saved_run(exp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = timing.pop()
        log.append(dict(exp=exp, wall=wall, run_s=rec["run_s"],
                        steps=rec["slots_run"],
                        peak=torch.cuda.max_memory_allocated(),
                        peak_reserved=torch.cuda.max_memory_reserved()))
        return res

    def hop_distances(*a, **kw):
        out = saved_hops(*a, **kw)
        products.append(out[2])
        return out

    loop.run, routing.hop_distances = run, hop_distances
    try:
        with timed_runs(timing):
            yield
    finally:
        loop.run, routing.hop_distances = saved_run, saved_hops


def run_phase19() -> dict:
    """The memory model against the card, an admission refusal, and the
    cut 1k design-space search against the reference's record.  Returns
    the search's launches."""
    import torch
    from repro_torch.search import SearchSpec, search
    phase("19. memory, admission and search")
    print("device_peak_bytes against the measured peaks of phases 8, 15 "
          "and 16 (H100 80GB HBM3 allocator):")
    for label, m in MEASURED.items():
        hold_model(label, m["exp"], m["peak"], m["peak_reserved"])
    fit_step_bytes()
    refuse_ft50()

    golden = json.loads(SEARCH_GOLDEN.read_text())
    spec = SearchSpec.from_dict(golden["spec"])
    log, products = [], []
    reset_counts()
    t0 = time.perf_counter()
    with search_runs(log, products):
        rec = search(spec, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"search {spec.label()} ({spec.budget} of {rec['space_size']} "
          f"candidates, screen {spec.screen_warm} + {spec.screen_measure}, "
          f"full {spec.warm} + {spec.measure}, mem_budget_mib "
          f"{spec.mem_budget_mib}): {wall:.3f} s; counts {rec['counts']}; "
          f"frontier {rec['frontier']}")
    for r in log:
        exp = r["exp"]
        print(f"  {exp.name}: set-up {r['wall'] - r['run_s']:.3f} s, run "
              f"{r['run_s']:.3f} s, {r['steps']} slots "
              f"({r['steps'] / r['run_s']:.2f} slots/s); peak device "
              f"memory {r['peak']} bytes allocated, {r['peak_reserved']} "
              "reserved")
        hold_model(exp.name, exp, r["peak"], r["peak_reserved"])
    got = json.loads(json.dumps(rec))
    want = golden["record"]
    for c in got["candidates"]:
        pred = c.pop("predicted_device_bytes", None)
        print(f"  {c['id']} {c['label']}: {c['status']}"
              + (f", predicted_device_bytes {pred}" if pred else "")
              + (f", {c['reason']}" if c["status"] == "pruned" else ""))
    want = dict(want, candidates=[
        {k: v for k, v in c.items() if k != "predicted_rss_bytes"}
        for c in want["candidates"]])
    _differs(spec.label(), got, want)
    print(f"the search record equals {SEARCH_GOLDEN.name} field for field "
          "(less predicted_device_bytes / predicted_rss_bytes)")
    steps = sum(r["steps"] for r in log)
    check_counts(counts, {**NO_LAUNCHES, "vc_prearb": 3 * steps,
                          "switch_arbitrate_rows": 2 * steps,
                          "minplus_hops": sum(products)},
                 f"the search ({steps} steps, {len(products)} table builds)")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------- #
# LM serving slice: Hymba-1.5B
# ---------------------------------------------------------------------- #
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4096, 32
# selective_scan's: the same float32 operations in the same order; only
# expf, taken from CUDA's math library by both but compiled separately,
# may differ by an ulp, which the contracting recurrence (|exp(dt A)| <= 1)
# does not grow
SCAN_TOL = 1e-5


def run_lm_kernels(cfg) -> dict:
    """Both LM kernels against their plain versions at the serving slice's
    shapes and at ragged ones; returns each kernel's record for one
    prefill launch (flash_attention averaged over the prefill's full and
    windowed layers)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import bench as fa_bench
    from repro_torch.kernels.selective_scan import bench as ss_bench
    from repro_torch.kernels.selective_scan import kernel as ss
    from repro_torch.kernels.selective_scan import selective_scan_ref
    phase("9. LM kernels vs plain, on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    B, S = SERVE_BATCH, SERVE_PROMPT
    W = cfg.sliding_window
    n_full = len(cfg.full_attn_layers)
    n_win = cfg.n_layers - n_full

    # flash_attention: the six cases, their check (compare_bf16) and the
    # timings of the serving shapes live in the kernel's bench module
    lib = _build.build_all(["flash_attention"])["flash_attention"]["path"]
    print(f"SASS of flash_attention_kernel: {fa_bench.sass_counts(lib)}")
    out = fa_bench.run_cases(cfg, gen, B, S)
    flash = out["timed"]
    # one prefill launch on average: n_full full layers, n_win windowed
    fa_rec = {key: (n_full * flash[None][key] + n_win * flash[W][key])
              / cfg.n_layers
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    fa_rec.update(bound_by=flash[W]["bound_by"],
                  max_abs_err=out["max_abs_err"])

    # selective_scan: the cases, the SASS counts and the bound live in the
    # kernel's bench module
    Di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    if (B, S, Di, N) != (*ss_bench.SERVE, ss_bench.STATE):
        raise AssertionError(f"the scan bench times {ss_bench.SERVE}, the "
                             f"serving slice is {(B, S, Di)}")
    lib = _build.build_all(["selective_scan"])["selective_scan"]["path"]
    print(f"SASS of selective_scan_kernel: {ss_bench.sass_counts(lib)}")
    print(f"launch plan at [{B},{S},{Di},{N}]: {ss.plan(0, B, Di)}")
    scan_errs = []
    results = ss_bench.run_cases(gen, exact=False)
    for r in results:
        tol = SCAN_TOL * r["scale"]
        print(f"  {r['label']}: max_abs_err {r['max_abs_err']!r} within "
              f"the tolerance {tol!r}: {r['max_abs_err'] <= tol}")
        if not r["max_abs_err"] <= tol:
            raise AssertionError(f"selective_scan differs from its plain "
                                 f"version at {r['label']}")
        scan_errs.append(r["max_abs_err"])
    args = results[0]["args"]
    ms = cuda_ms(lambda: ss.selective_scan(*args), iters=10, warmup=2)
    plain = cuda_ms(lambda: selective_scan_ref(*args), iters=1, warmup=1)
    bnd = ss_bench.scan_bound_ms(B, S, Di, N)
    scan = dict(ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    print(f"  [{B},{S},{Di},{N}]: kernel {ms:.6f} ms per launch, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['limit']}; bytes "
          f"{bnd['bytes_ms']:.6f}, float32 {bnd['fp32_ms']:.6f}, MUFU ex2 "
          f"{bnd['ex2_ms']:.6f} ms), {100 * bnd['bound_ms'] / ms:.2f}% of "
          f"the bound; plain {plain:.6f} ms; no PyTorch call computes this "
          "scan")
    del args, results
    scan["max_abs_err"] = max(scan_errs)
    torch.cuda.empty_cache()
    return {"flash_attention": fa_rec, "selective_scan": scan}


# the golden's logits against the card's, within these, with reasons: the
# card's bf16 products (cuBLAS) and attention and scan kernels sum in
# other orders than the reference's XLA on a CPU, so single bf16 values
# flip by one ulp in every layer and the flips add up over 32 layers; the
# top-8 logits (about 3 here, bf16 ulp 2^-6) are held to 4 ulps of the top
# logit; the logsumexp, a softmax-weighted mean of the logits' errors over
# the vocabulary, to a quarter of one ulp
LOGIT_TOL = 2 ** -4
LSE_TOL = 2 ** -8


def _check_step(label: str, logits, ref: dict, vocab: int) -> dict:
    """Hold one position's logits [V] to a golden step record; returns
    the errors."""
    import numpy as np
    x = logits[:vocab].float().cpu().numpy().astype(np.float64)
    top_err = float(max(abs(x[t] - v) for t, v in ref["top"]))
    lse = float(x.max() + np.log(np.exp(x - x.max()).sum()))
    lse_err = abs(lse - ref["lse"])
    top1 = int(np.argmax(x))
    decisive = ref["margin"] > 2 * LOGIT_TOL
    ok = top_err <= LOGIT_TOL and lse_err <= LSE_TOL and \
        (top1 == ref["top"][0][0] or not decisive)
    print(f"{label}: top-8 max_abs_err {top_err!r}, logsumexp err "
          f"{lse_err!r}, top-1 {top1} (golden {ref['top'][0][0]}, margin "
          f"{ref['margin']!r}{'' if decisive else ', a near tie'})"
          f"{'' if ok else '  <-- FAILS'}")
    if not ok:
        raise AssertionError(f"Hymba {label} differs from the JAX golden")
    return {"top": top_err, "lse": lse_err}


def golden_prompt(golden: dict):
    import numpy as np
    return np.random.default_rng(golden["prompt_seed"]).integers(
        0, golden["vocab"], (1, golden["prompt_len"]), dtype=np.int32)


def run_hymba_golden(cfg, params) -> None:
    """The full config teacher-forced on the golden's prompt and tokens."""
    import torch
    from repro_torch.models.model import decode_step, prefill
    phase("10. Hymba-1.5B golden on the card")
    golden = json.loads(HYMBA_GOLDEN.read_text())
    dev = torch.device("cuda")
    toks = torch.as_tensor(golden_prompt(golden), device=dev)
    errs = []
    with torch.inference_mode():
        logits, cache = prefill(params, toks, cfg)
        errs.append(_check_step("prefill", logits[0, -1], golden["steps"][0],
                                cfg.vocab))
        for i, tok in enumerate(golden["tokens"][:-1]):
            logits, cache = decode_step(
                params, cache, torch.tensor([[tok]], device=dev),
                golden["prompt_len"] + i, cfg)
            errs.append(_check_step(f"decode step {i}", logits[0, -1],
                                    golden["steps"][i + 1], cfg.vocab))
    print(f"{len(errs)} positions within tolerance: top-8 max_abs_err "
          f"{max(e['top'] for e in errs)!r} (tolerance {LOGIT_TOL}), "
          f"logsumexp {max(e['lse'] for e in errs)!r} (tolerance {LSE_TOL})")
    del cache
    torch.cuda.empty_cache()


def _kind(key: str) -> str:
    """The class of a device kernel, by its name."""
    low = key.lower()
    if "flash_attention_kernel" in key:
        return "flash_attention"
    if "selective_scan_kernel" in key:
        return "selective_scan"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "copy" in low:
        return "copy/cast"
    return "other elementwise/reduction"


def _profile(fn) -> tuple:
    """(device rows sorted by time, device busy s, wall s) of ``fn()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.count,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    return rows, sum(r[0] for r in rows) / 1e6, wall


def run_serving(cfg, params) -> dict:
    """4 requests of 4,096 tokens, 32 new tokens each, through
    ``ServeSession.generate``; returns the main path's launches and each
    LM kernel's device ms per launch from the profiler."""
    import numpy as np
    import torch
    import repro_torch.launch.serve as serve
    phase("11. serving: ServeSession.generate, 4 x 4,096 tokens + 32")
    golden = json.loads(HYMBA_GOLDEN.read_text())
    prompts = np.concatenate([golden_prompt(golden),
                              np.random.default_rng(11).integers(
                                  0, cfg.vocab,
                                  (SERVE_BATCH - 1, SERVE_PROMPT),
                                  dtype=np.int32)])
    sess = serve.ServeSession(cfg, params=params, device="cuda")

    # the prefill's time and the launches of prefill and decode, read
    # around the user's call without changing it
    seen = {"decode_launches": []}
    prefill_fn, decode_fn = serve.prefill, serve.decode_step

    def timed_prefill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill_fn(*args, **kw)
        torch.cuda.synchronize()
        seen["prefill_s"] = time.perf_counter() - t0
        seen["prefill_launches"] = read_counts()
        return out

    def counted_decode(*args, **kw):
        before = read_counts()
        out = decode_fn(*args, **kw)
        after = read_counts()
        seen["decode_launches"].append(
            {k: after[k] - before[k] for k in after})
        return out

    serve.prefill, serve.decode_step = timed_prefill, counted_decode
    try:
        sess.generate(prompts[:, :64], 2)            # warm-up, short
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        seen["decode_launches"].clear()
        t0 = time.perf_counter()
        toks = sess.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        serve.prefill, serve.decode_step = prefill_fn, decode_fn
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_s = wall - seen["prefill_s"]
    n_tok = SERVE_BATCH * SERVE_NEW
    print(f"generated {toks.shape}; wall {wall:.3f} s = prefill "
          f"{seen['prefill_s']:.3f} s + {SERVE_NEW - 1} decode steps "
          f"{decode_s:.3f} s ({1e3 * decode_s / (SERVE_NEW - 1):.3f} ms per "
          f"step of {SERVE_BATCH} tokens); {n_tok / wall:.2f} generated "
          f"tokens/s end to end, {SERVE_BATCH * (SERVE_NEW - 1) / decode_s:.2f}"
          f" tokens/s in decode, "
          f"{SERVE_BATCH * SERVE_PROMPT / seen['prefill_s']:.1f} prompt "
          f"tokens/s in prefill; peak device memory {peak} bytes")
    per_prefill = {**NO_LAUNCHES, "flash_attention": cfg.n_layers,
                   "selective_scan": cfg.n_layers}
    check_counts(seen["prefill_launches"], per_prefill, "the prefill")
    for i, d in enumerate(seen["decode_launches"]):
        if any(d.values()):
            raise AssertionError(f"decode step {i} launched kernels: {d}")
    print(f"{len(seen['decode_launches'])} decode steps launched no kernel "
          "of the port")
    check_counts(launches, per_prefill, "the serving run")

    # row 0 must give the golden's tokens, up to a near tie of the golden
    want = golden["tokens"]
    for i, (got, ref) in enumerate(zip(toks[0].tolist(), want)):
        if got != ref:
            margin = golden["steps"][i]["margin"]
            print(f"row 0 leaves the golden at token {i} (margin {margin})")
            if margin > 2 * LOGIT_TOL:
                raise AssertionError(f"row 0 token {i}: {got} != {ref} at a "
                                     f"clear margin {margin}")
            break
    else:
        print(f"row 0's first {len(want)} tokens equal the golden's")

    # where a prefill's time goes, and the device's busy share in a
    # prefill and in decode steps, from the profiler
    per_launch = {}
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        rows, busy_s, wall = _profile(lambda: prefill_fn(sess.params, toks,
                                                         cfg))
        if not rows:
            print("profiler: device time not measured (no device events)")
            return {"launches": launches, "per_launch": per_launch}
        print(f"profiler, one prefill of {SERVE_BATCH} x {SERVE_PROMPT}: "
              f"wall {wall:.4f} s, device busy {busy_s:.4f} s, idle share "
              f"{100 * (1 - busy_s / wall):.1f}%")
        kinds = {}
        for dev_us, count, key in rows:
            kind = _kind(key)
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e6
            if kind in ("flash_attention", "selective_scan"):
                per_launch[kind] = dev_us / count / 1e3
                print(f"  {kind}: {dev_us / count / 1e3:.6f} ms per launch "
                      f"on the main path ({count} launches)")
        print("prefill device time by kind: " + ", ".join(
            f"{k} {v:.4f} s ({100 * v / busy_s:.1f}%)"
            for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
        for dev_us, count, key in rows[:12]:
            print(f"  {dev_us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")
        _, cache = prefill_fn(sess.params, toks, cfg)
        tok = toks[:, -1:]
        n_dec = 4
        rows, busy_s, wall = _profile(lambda: [
            decode_fn(sess.params, cache, tok, SERVE_PROMPT + i, cfg)
            for i in range(n_dec)])
        n_ops = sum(r[1] for r in rows) / n_dec
        print(f"profiler, {n_dec} decode steps: wall {1e3 * wall / n_dec:.3f}"
              f" ms per step, device busy {1e3 * busy_s / n_dec:.3f} ms per "
              f"step in {n_ops:.0f} device operations, idle share "
              f"{100 * (1 - busy_s / wall):.1f}%")
    return {"launches": launches, "per_launch": per_launch}


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
    from repro_torch.kernels.switch_arb import bench as arb_bench
    exp = Experiment.from_dict(json.loads(FIG5_GOLDEN.read_text())
                               ["experiment"])
    tables = build_tables(build_network(exp.network), device="cuda")
    print(f"{tables.squarings} minplus_hops products build the Figure-5 "
          "tables")

    points = {label: Experiment.from_dict(json.loads(path.read_text())
                                          ["experiment"])
              for label, path in A2A_GOLDENS.items()}
    records = run_kernels({label: arb_bench.geometry(label, "cuda")
                           for label in arb_bench.GEOMETRIES})
    fig7 = fig7_points()
    topos = {label: build_network(p.network) for label, p in points.items()}
    topos.update({label: build_network(exp.network)
                  for label, (exp, _, _) in fig7.items()
                  if label.endswith(".all2all")})
    records["minplus"] = run_minplus(
        tables.topo.nbrs, {label: t.nbrs for label, t in topos.items()
                           if label.startswith("fig6.")})
    records["minplus_hops"] = run_minplus_hops(topos)
    del topos
    run_golden()
    launches = dict.fromkeys(KERNELS, 0)
    per_launch, fig5_slot = run_breakdown(tables, exp)
    del tables
    squarings = run_tables(points)
    for k, n in run_all2all(points, squarings).items():
        launches[k] += n
    for k, n in run_fig7(fig7).items():
        launches[k] += n
    for k, n in run_phase13().items():
        launches[k] += n
    for k, n in run_phase14().items():
        launches[k] += n
    for k, n in run_phase15(fig5_slot).items():
        launches[k] += n
    for k, n in run_phase16(fig5_slot).items():
        launches[k] += n
    for k, n in run_phase17(fig5_slot).items():
        launches[k] += n
    for k, n in run_phase18(fig5_slot).items():
        launches[k] += n
    for k, n in run_phase19().items():
        launches[k] += n

    # the LM serving slice: Hymba-1.5B at full width
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_specs
    cfg = get_config("hymba-1.5b")
    records.update(run_lm_kernels(cfg))
    t0 = time.perf_counter()
    params = init_params(build_specs(cfg), 0, "cuda")
    torch.cuda.synchronize()
    print(f"hymba-1.5b weights from the seeded numpy synthesis: "
          f"{cfg.param_count()} parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    run_hymba_golden(cfg, params)
    serving = run_serving(cfg, params)
    phase()
    for k in ("flash_attention", "selective_scan"):
        launches[k] += serving["launches"][k]
    per_launch.update(serving["per_launch"])

    # a kernel's time is its device time per launch on the main path where
    # the profiler saw it, else the back-to-back launch time of phase 3 or
    # 9 (an upper bound: Python launches no faster than a few
    # microseconds).  Launches are summed over the main-path runs of
    # phases 8, 12, 13, 14, 15, 16, 17, 18 (in process), 19 and 11.
    for k in records:
        records[k]["launches"] = launches[k]
        records[k]["ms"] = per_launch.get(k, records[k]["ms"])
    out = [{"name": k, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")}
           for k, rec in records.items()]
    print(f"\nchip_smoke total: {time.perf_counter() - T_START:.3f} s wall")
    print("kernels: " + "; ".join(
        f"{r['name']} launches {r['launches']} max_abs_err "
        f"{r['max_abs_err']!r} {r['ms']:.6f} ms (bound {r['bound_ms']:.6f} "
        f"ms)" for r in out))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
