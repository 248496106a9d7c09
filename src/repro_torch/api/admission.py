"""Admission control on the device: refuse before building, not after an
out-of-memory error.

The reference's gate (``repro.api.admission``) prices the JAX engine's
resident arrays with ``estimate_memory``, multiplies them by an XLA
compile-RAM factor and compares the product with host RAM.  The port has
no compiler: it runs out of memory on the card, and its table build
squares an ``[N, N]`` int16 adjacency there, which the reference never
holds.  So the gate prices an experiment with the port's own byte model,
:func:`device_peak_bytes`, which mirrors what the port allocates:

* the table build's peak: on the card the two padded ``[N, N]`` int16
  matrices that :func:`repro_torch.core.routing.hop_distances` squares
  into each other, with its stopping rule's row blocks; on the CPU the
  host BFS's int16 rows and its block of frontiers;
* ``dist_leaf`` ``[N1, N]`` int16, held by the tables and copied by the
  simulator;
* the device masks: one ``[N1 * N, W]`` int32 table, two under
  ``polarized`` and ``degraded`` (``Simulator._build_device_masks``),
  and the packing's leaf-block scratch;
* the simulator's index tables (``_link_dq`` is int64, ``[N * P, V]``;
  ``_ugal_occ_idx`` ``[S, P]`` int64 under ``ugal``);
* the state of each replica (``make_state`` / ``make_batch_state``, the
  pool's pad slot included), the traffic's own entries (the arrival
  FIFOs, a permutation, a program's arrays, shared by the replicas) and
  an armed schedule's tables and live masks;
* per-replica step transients, and for an armed schedule on the card
  the delta rebuild's squaring;
* a floor for PyTorch's caching allocator.

The peak is the largest of the build's peak, the simulator's set-up and
the resident total plus the transients.  The resident terms are exact:
``tests/test_torch_memory.py`` holds them to the summed ``nbytes`` of a
CPU simulator and its states.  The transient and floor coefficients are
fitted on the card, below.

``check_admission(experiment)`` runs inside ``run``, ``run_all`` and
``run_resumable`` / ``resume`` before anything is built, in the mode of
``REPRO_ADMISSION`` (``auto`` | ``warn`` | ``off``): an experiment that
fits its device's budget is admitted, one that does not is refused with
an :class:`AdmissionError` that says what to change (``warn`` prints the
reason and admits it).  The budget on the card is its free bytes
(``torch.cuda.mem_get_info``) plus the blocks PyTorch's cache holds
unused; on the CPU, host RAM.  The port keeps a single mask layout, so
there is no ``downgrade`` action: what the reference would rescue by
streaming its masks in blocks, the port refuses.  Decisions are memoized
per (network, route, replicas, budget, mode), and the parts of the
workload and device that change the layout.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from .._device import resolve_device
from .memory import format_bytes
from .registry import network_topology
from .specs import Experiment, NetworkSpec

__all__ = ["AdmissionError", "AdmissionDecision", "STEP_BYTES_PER_PORT_ROW",
           "STEP_SHARED_BYTES_PER_PORT_ROW", "ALLOCATOR_SLACK",
           "ALLOCATOR_FLOOR_BYTES", "host_ram_bytes",
           "device_budget_bytes", "device_bytes", "device_peak_bytes",
           "check_admission"]

# ---- fitted on the card ------------------------------------------------ #
# A slot's transients scale with the requester-port pairs NR * P (the
# [R, NR, P] port planes of routing, the arbitration kernel's inputs and
# the queue buffers a step rebinds): STEP_BYTES_PER_PORT_ROW a replica
# and STEP_SHARED_BYTES_PER_PORT_ROW whatever the replicas.  The caching
# allocator reserves more than is allocated (blocks split and cached
# across a run, 2 MiB and 20 MiB segments under the small tensors):
# ALLOCATOR_SLACK of the allocated peak and ALLOCATOR_FLOOR_BYTES on top.
# Fitted on an H100 80GB HBM3 at a 700.00 W power limit to the
# allocated peak less the resident bytes, per pair, that phase 19 of
# chip_smoke.py prints for the Figure-5 MRLS runs: 73.43 at one replica
# (73.17 on mrls(5832, 18, 18), 66.29 on the 100k Fat-Tree under
# minimal_adaptive) and 221.74 at four (Figure 5's uniform row).  The
# line through the two, 49.44 R + 23.99, rounds to 49 R + 24; phase 19
# prints that fit beside these constants.  (The constants were first
# read off an earlier exploration run on the same card, whose readings
# phase 19 reproduces within 1 %.)  Reserved over allocated is 1.07
# to 1.31 in those runs at 11k endpoints and above; the floor keeps the
# 1k runs' reserved peaks, up to 2.3 times their allocated ones (small
# blocks rounded up), under the price.  The CPU has no caching
# allocator: there the peak is the raw bytes.
STEP_BYTES_PER_PORT_ROW = 49
STEP_SHARED_BYTES_PER_PORT_ROW = 24
ALLOCATOR_SLACK = 0.25
ALLOCATOR_FLOOR_BYTES = 64 << 20

# the table build's blocks: the stopping rule's reduction rows
# (core.routing._FINAL_ROWS) and the host BFS's block of sources
_FINAL_ROWS = 1024
_BFS_BLOCK = 256

_I32, _I64 = 4, 8


class AdmissionError(RuntimeError):
    """The experiment's predicted peak exceeds its device's budget; it was
    refused before anything was built."""


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    action: str                  # "admit" | "refuse" | "off"
    predicted_bytes: int         # device_peak_bytes of the experiment
    resident_bytes: int          # its resident total (tables to states)
    budget_bytes: Optional[int]
    device: str = ""
    reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def host_ram_bytes() -> Optional[int]:
    """MemTotal from ``/proc/meminfo`` (None on non-Linux hosts)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def device_budget_bytes(device=None) -> Optional[int]:
    """What an experiment may take on ``device``: on the card its free
    bytes plus the blocks PyTorch's cache holds unused; on the CPU host
    RAM."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        return int(free + cached)
    return host_ram_bytes()


# ---------------------------------------------------------------------- #
# the byte model
# ---------------------------------------------------------------------- #
_dims_memo: dict = {}


def _dims(network: NetworkSpec) -> dict:
    """The topology's sizes (one host build per fabric)."""
    key = (network.family, network.params)
    dims = _dims_memo.get(key)
    if dims is None:
        topo = network_topology(network)
        dims = _dims_memo[key] = {
            "N": topo.n_switches, "P": topo.max_ports, "N1": topo.n_leaves,
            "S": topo.n_endpoints, "d": topo.endpoints_per_leaf}
    return dims


def _program_phases(experiment: Experiment, S: int) -> Optional[int]:
    """The phase count of a collective that runs as a workload program,
    else None."""
    from ..workloads import build_collective_program
    from .runner import _is_program
    if not _is_program(experiment):
        return None
    w = experiment.workload
    return build_collective_program(w.pattern, S, rounds=w.rounds,
                                    ranks=w.ranks,
                                    vec_packets=w.vec_packets).n_phases


def _workload_key(experiment: Experiment):
    """What of the workload changes the state's layout."""
    from .runner import _is_program
    w = experiment.workload
    if _is_program(experiment):
        return ("program", w.pattern, w.rounds, w.ranks, w.vec_packets)
    if w.pattern in ("rep", "rsp", "bursty"):
        return (w.pattern,)
    if experiment.resolved_metric() == "serving":
        return ("arrival", w.arr_depth)
    return ()


def device_bytes(experiment: Experiment, device=None) -> dict:
    """The port's byte model of ``experiment`` on ``device`` (the card by
    default; pricing needs no card), term by term.  ``peak_bytes`` is
    :func:`device_peak_bytes`."""
    dev = torch.device("cuda" if device is None else device)
    dims = _dims(experiment.network)
    N, P, N1, S = dims["N"], dims["P"], dims["N1"], dims["S"]
    route = experiment.route
    V, Q, OQ, QE = (route.vcs, route.queue_depth, route.out_queue,
                    route.endpoint_queue)
    W = (P + 31) // 32
    NP, NQ, NR = N * P, N * P * V, N * P + S
    pool = route.pool or int(min(2_000_000, max(1 << 14, S * 6)))
    n_masks = 2 if route.policy in ("polarized", "degraded") else 1
    mask = N1 * N * W * _I32
    dist = N1 * N * 2
    failures = experiment.network.failures
    armed = failures is not None and len(failures) > 0
    metric = experiment.resolved_metric()
    # resilience runs its replicas one after the other
    live = 1 if metric == "resilience" else experiment.replicas

    # ---- the table build (alone on the device) ----------------------- #
    if dev.type == "cuda":
        ld = max(8, -(-N // 8) * 8)
        square = N * ld * 2                 # one padded int16 [N, N]
        # the two matrices, the symmetry test's [N, N] bool (its block
        # stays cached beside them) and a block of the stopping rule
        build = max(2 * square + N * N + min(_FINAL_ROWS, N1) * N * 3,
                    square + 2 * P * N * _I64,        # the adjacency
                    square + dist + N1 * N)           # the leaf rows out
    else:
        square = 0
        build = dist + _BFS_BLOCK * N * 4 + _BFS_BLOCK * NP * 2 * _I64

    # ---- the simulator: tables, masks, index tables ------------------- #
    constants = (
        N1 * _I32                            # leaf_ids
        + dist                               # dist (the simulator's copy)
        + n_masks * mask                     # min_mask (+ away_mask)
        + P * (_I64 + _I32)                  # _w_idx, _b_idx
        + (V + Q + OQ + QE) * _I32           # the small aranges
        + S * _I32 + pool * _I32             # _e, _fl_fresh
        + NP * V * _I64                      # _link_dq
        + NP * _I32 + NP                     # _link_nb, _valid
        + NR * _I32 + NR * _I64              # cur, _row_of
        + N * _I32 + NP * _I32               # _nic_first, _dq_base
        + NP * _I64                          # _rev_idx
        + (S * P * _I64 if route.policy == "ugal" else 0))
    simulator = dist + constants             # + the tables' dist_leaf
    # the set-up's scratch: the connectivity test over dist_leaf and the
    # mask packing of one leaf block
    blk = min(256, N1)
    setup = max(N1 * N, blk * N * (2 * W * _I32 + 12) + 2 * NP * _I64)

    # ---- the state of one replica ------------------------------------ #
    state = (NQ * Q * _I32 + 2 * NQ * _I32          # qbuf, qhead, qlen
             + NQ * OQ * _I32 + 2 * NQ * _I32       # oq_buf, oq_head/len
             + S * QE * _I32 + 2 * S * _I32         # eq_buf, eq_head/len
             + 4 * (pool + 1) * _I32                # fl_buf, p_sd/mid/bh
             + 2 * _I32                             # fl_head, fl_len
             + 3 * S * _I32                         # msg_rem/dst, prog
             + 4 * _I32                             # the counters
             + route.hist_bins * _I32               # lat_hist
             + _I32 + 2 * _I32)                     # slot, key
    w = experiment.workload
    shared = 0
    phases = _program_phases(experiment, S)
    if phases is not None:
        # the program's arrays, one copy for every replica, and the
        # scheduler's registers
        shared = 2 * phases * S * _I32 + 2 * phases * _I32
        state += _I32 + phases * (_I32 + 1) + 2 * _I32
    elif metric == "serving":
        D = w.arr_depth
        state += 2 * S * D * _I32 + 3 * S * _I32 + 2 * _I32
    elif w.pattern in ("rep", "bursty"):
        state += S * _I32
    elif w.pattern == "rsp":
        state += N1 * _I32
    failure_state = ((n_masks * mask + dist + NP + N + _I32)
                     if armed else 0)
    state += failure_state

    # ---- transients of a run ------------------------------------------ #
    step = STEP_BYTES_PER_PORT_ROW * NR * P
    step_shared = STEP_SHARED_BYTES_PER_PORT_ROW * NR * P
    # make_batch_state holds the replicas' states and their stack at once
    make = live * state if live > 1 else 0
    delta = 0
    if armed:
        # a transition's rebuild: every leaf row at worst, squared on the
        # card, and its rows' mask words
        delta = 2 * square + N1 * N * (2 + 2 * W * _I32)
    transient = max(live * step + step_shared, make, delta)

    resident = simulator + shared + live * state
    body = max(simulator + setup, resident + transient)
    raw = max(build, body)
    peak = (int(raw * (1 + ALLOCATOR_SLACK) + ALLOCATOR_FLOOR_BYTES)
            if dev.type == "cuda" else raw)
    return {
        "device": dev.type,
        "n_endpoints": S,
        "n_port_rows": NR * P,
        "replicas": live,
        "build_bytes": build,
        "simulator_bytes": simulator,
        "setup_bytes": setup,
        "state_bytes_per_replica": state,
        "failure_state_bytes_per_replica": failure_state,
        "program_bytes": shared,
        "step_bytes_per_replica": step,
        "step_shared_bytes": step_shared,
        "transient_bytes": transient,
        "resident_bytes": resident,
        "peak_bytes": peak,
    }


def device_peak_bytes(experiment: Experiment, device=None) -> int:
    """The port's predicted peak device bytes of ``experiment`` on
    ``device`` (the card by default): the gate's price, and the
    supervisor's preflight."""
    return device_bytes(experiment, device)["peak_bytes"]


# ---------------------------------------------------------------------- #
# the gate
# ---------------------------------------------------------------------- #
def _mode() -> str:
    mode = os.environ.get("REPRO_ADMISSION", "auto").lower()
    if mode not in ("auto", "warn", "off"):
        raise ValueError(f"REPRO_ADMISSION={mode!r} (expected auto|warn|off)")
    return mode


_memo: dict = {}


def check_admission(experiment: Experiment, *,
                    budget_bytes: Optional[int] = None,
                    mode: Optional[str] = None,
                    device=None) -> AdmissionDecision:
    """Price ``experiment`` against its device's budget before anything
    is built.

    ``device`` as in ``run`` (the card unless ``"cpu"`` is asked for).
    ``budget_bytes`` defaults to :func:`device_budget_bytes`; ``mode``
    defaults to ``REPRO_ADMISSION`` (``auto``).  Returns the decision;
    raises :class:`AdmissionError` in ``auto`` mode when the predicted
    peak exceeds the budget.
    """
    mode = mode if mode is not None else _mode()
    if mode not in ("auto", "warn", "off"):
        raise ValueError(f"admission mode {mode!r} (expected auto|warn|off)")
    if mode == "off":
        return AdmissionDecision(True, "off", 0, 0, None)
    dev = resolve_device(device)
    if budget_bytes is None:
        budget_bytes = device_budget_bytes(dev)
    key = (experiment.network, experiment.route, experiment.replicas,
           budget_bytes, mode, dev.type, experiment.resolved_metric(),
           _workload_key(experiment))
    hit = _memo.get(key)
    if hit is None:
        hit = _memo[key] = _decide(experiment, budget_bytes, mode, dev)
    if isinstance(hit, AdmissionError):
        raise hit
    return hit


def _decide(experiment: Experiment, budget_bytes: Optional[int], mode: str,
            dev: torch.device):
    est = device_bytes(experiment, dev)
    predicted, resident = est["peak_bytes"], est["resident_bytes"]
    if budget_bytes is None or predicted <= budget_bytes:
        return AdmissionDecision(True, "admit", predicted, resident,
                                 budget_bytes, dev.type)
    reps = est["replicas"]
    reason = (
        f"experiment {experiment.label()!r} predicts a peak of "
        f"{format_bytes(predicted)} on {dev.type} (table build "
        f"{format_bytes(est['build_bytes'])}, simulator "
        f"{format_bytes(est['simulator_bytes'])}, {reps} replica(s) of "
        f"{format_bytes(est['state_bytes_per_replica'])} state and "
        f"{format_bytes(est['step_bytes_per_replica'])} step transients) "
        f"but the budget is {format_bytes(budget_bytes)}"
        + (" (the card's free bytes and PyTorch's unused cached blocks)"
           if dev.type == "cuda" else " (host RAM)") + ". "
        "Options: fewer replicas (each adds its state and transients), "
        "release other simulators on the device (SimulatorCache.release / "
        "close, torch.cuda.empty_cache), a smaller fabric, a card with "
        "more memory, or device='cpu' against host RAM. "
        "Set REPRO_ADMISSION=warn to proceed anyway at your own risk.")
    if mode == "warn":
        print(f"[admission] WARNING: {reason}")
        return AdmissionDecision(True, "admit", predicted, resident,
                                 budget_bytes, dev.type, reason=reason)
    return AdmissionError(reason)
