"""Cycle-level interconnection-network simulator in PyTorch.

The port of the reference engine (``repro.simulator.engine``): the same
slotted, input-queued, credit-based switch model, the same state layout
and the same threefry stream, so a run gives bit for bit the reference's
state and statistics.  Slotted time — one slot is one packet
serialization on a link.  Each slot runs ``_inject``, ``speedup``
crossbar sub-rounds and the link phase.

A crossbar sub-round runs the two arbitration steps through
:mod:`repro_torch.kernels.switch_arb`: on the card they are the
hand-written CUDA kernels, on the CPU (only when the caller asks for
``device="cpu"``) their plain PyTorch versions.  ``vc_prearb`` also
gathers the chosen queue's head packet; ``switch_arbitrate_rows`` reads
the occupancies from the queue state itself and works on the flat
requester rows.  The link phase's choice of output VC is the same masked
argmax as VC pre-arbitration and runs through the same kernel.

Policies: ``polarized``, ``minimal_adaptive``, ``ksp``, ``degraded``,
and the Dragonfly's ``ugal`` (UGAL-L: a Valiant intermediate leaf when the
queue-times-distance estimate says so) and ``valiant`` (always an
intermediate leaf).  Traffic: the Bernoulli families ``uniform``,
``rep``, ``rsp``, ``bu``, ``mice_elephant`` and the adversarial
``tornado``, ``shift``, ``hotspot`` and ``bursty`` (measured by
``run_throughput``/``run_latency``), ``arrival`` (the open-loop serving
source, measured by ``run_serving``), ``all2all`` (a finite program,
measured by ``run_completion``), ``phase`` (one exchange with a partner
row the caller sets, measured by ``run_completion(state=...)``) and
``program``: a compiled workload program
(:class:`repro_torch.workloads.CompiledProgram`) run by the phase
scheduler ``_advance_program`` at the end of every slot and driven by
``run_program``.  ``schedule="barrier"`` replays the per-phase host loop
bitwise (a crossing resets the transient state and the key to what a
fresh state holds); ``schedule="window"`` lets endpoints run ``window``
phases ahead of the completed ones.

Failures (``failures=``, a ``FailureSchedule``): a *static* branch, as
in the reference.  With no schedule, or an empty one, the step issues
exactly the operations it issues without the branch.  With one, the
routing tables move into the state (``tbl_min``, ``tbl_away``,
``tbl_dist``: copies, never views, of the simulator's tables) beside the
liveness masks ``link_up`` / ``switch_up`` and the ``fail_drop``
counter; every policy reads the state's tables and gates its candidate
ports to live ones (``live_row``), the link phase gates its sends, and
``update_tables`` writes a ``TableDelta``'s rows into them between
slots.  ``degraded`` routes minimally over live ports and, where none is
left, falls back to a live away port within the hop budget; on a
pristine fabric it is ``minimal_adaptive``.  ``run_resilience`` drives a
schedule: it applies each transition at its slot boundary
(``RoutingTables.apply_failures`` -> ``update_tables``, and
``drop_dead_packets`` under the ``drop`` policy) and restores the
pristine tables when it returns.

Replicas, the counterpart of the reference's ``jax.vmap``: a batched
state (``make_batch_state``, ``make_program_batch_state``) stacks R
independently seeded states on a leading ``[R]`` axis, and one step
advances all of them, with the same kernel launches as one replica:
the PRNG draws with ``[R, 2]`` keys, ``vc_prearb`` takes the replicas'
switches as ``R*N`` switches and ``switch_arbitrate_rows`` takes the
replica axis as a grid dimension.  Replica ``i`` is bitwise the scalar
run with seed ``seeds[i]``.  The step works on batched states: a scalar
state runs as one replica through ``unsqueeze(0)`` views, taken at the
entry of a run and written back at its exit, so the scalar path is the
same step.  The step functions themselves (``_step``, ``_inject``,
``_crossbar_round``, ``_link_phase``, ``_advance_program``) take
batched states only: a caller that drives them slot by slot makes an
``R = 1`` state with ``make_batch_state(traffic, [seed])``.  Measured by
``run_throughput_batch``, ``run_latency_batch``, ``run_completion``
(``run_completion_batch``) and ``run_program(seeds=)``, which go on a
chunk at a time until every replica is done, as the reference's loops.

State and its lifetime:

* The state is a dict of tensors on the simulator's device, with the
  reference's keys and dtypes.  The PRNG key is an int32 ``[2]`` tensor
  (``[R, 2]`` batched) holding the reference's two uint32 words (see
  :mod:`repro_torch.prng`).
* The pool-indexed tensors (``POOL_KEYS``) carry one pad slot at index
  ``pool`` of their last axis: the reference's ``mode="drop"`` scatters
  aim non-writers at index ``pool``; here they land in the pad slot,
  with no host sync.
  :func:`repro_torch.convert.state_to_numpy` strips it.
* ``run_chunk`` and the step functions update the state **in place**:
  they write into its tensors and rebind its entries, and return the
  same dict.  A state passed to them is consumed, as a donated state is
  in the reference; clone what you need to keep first.
* The step makes no host synchronisation: no ``.item()``, no
  ``nonzero``, no boolean-mask indexing.  ``run_completion`` and
  ``run_program`` sync once per chunk, to test whether to run the next
  one.  Nor does it loop over replicas: a replica's gathers and scatters
  into its own state rows go through flat offsets (``_flat``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import prng
from .._device import resolve_device
from ..core.routing import POLICIES, RoutingTables, pack_mask_block
from ..kernels.switch_arb.ops import (flat_rows_geometry,
                                      switch_arbitrate_rows, vc_prearb)
from ..workloads.patterns import (ARRIVAL_PATTERNS, bounded_pareto_mean,
                                  check_arrival, check_engine_pattern)
from . import arrivals

__all__ = ["SimConfig", "Traffic", "Simulator", "pack_mask_block",
           "percentiles", "POLICIES", "POOL_KEYS", "KEY_KEYS", "MASK_KEYS",
           "LATENCY_QS", "PROG_SHARED"]

# the policies that route through an intermediate leaf (p_mid)
_VALIANT_POLICIES = ("ugal", "valiant")

# percentile ladder of the latency runs: median, p99, p999, p9999
LATENCY_QS = (0.5, 0.99, 0.999, 0.9999)

# state tensors indexed by packet id; each has a pad slot at index pool
POOL_KEYS = {"fl_buf": 0, "p_sd": 0, "p_mid": -1, "p_bh": 0}
# state tensors holding a PRNG key (two uint32 words as int32)
KEY_KEYS = ("key", "key0")
# state tensors holding port-mask words (uint32 words as int32 views)
MASK_KEYS = ("tbl_min", "tbl_away")
# the state tensors the step writes into in place (index_put_ and
# index_add_ on their flat views)
_IN_PLACE = tuple(POOL_KEYS) + ("lat_hist",)
# the compiled program's arrays: the same for every replica, so a batched
# state keeps one unstacked copy (key -> its unbatched ndim, by which a
# caller-built state that stacked them is told apart)
PROG_SHARED = {"prog_partner": 2, "prog_packets": 2, "prog_expected": 1,
               "prog_expected_cum": 1}
# what a barrier crossing sets back to 0, as a fresh state holds it
_PHASE_RESET = ("slot", "ejected", "prog", "msg_rem", "qhead", "qlen",
                "oq_head", "oq_len", "eq_head", "eq_len", "fl_head")

_I32 = torch.int32


def _f32(x: float) -> float:
    """``x`` rounded to float32: the value a uniform draw is compared
    with where the reference compares it with a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    policy: str = "polarized"
    vcs: int = 4                 # V
    queue_depth: int = 8         # Q packets per (port, VC) at input
    out_queue: int = 4           # packets per (port, VC) at output
    speedup: int = 2             # crossbar sub-rounds per slot
    endpoint_queue: int = 4      # QE packets per NIC
    max_hops: int = 8            # routing hop bound (2D* - 2 for polarized)
    deroute_penalty: float = 8.0
    pool: Optional[int] = None   # packet pool size (default: auto)
    hist_bins: int = 4096        # latency histogram bins (slots)
    seed: int = 0
    # which of jax's two threefry streams to reproduce: the partitionable
    # one of current jax (default), or the original one that
    # tests/golden/engine_parity.json was captured with
    threefry_partitionable: bool = True


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Traffic program, with the reference's field order.

    * Bernoulli families: each idle endpoint starts a message with
      probability ``load`` / (mean message size) per slot.  ``uniform``
      sends one packet to a destination drawn uniformly over all
      endpoints; ``rep`` to a fixed random permutation of the endpoints,
      ``rsp`` to the same slot of a fixed random permutation of the
      leaves (both drawn from the run seed by ``make_state``); ``bu``
      from each half of the endpoints to a uniform endpoint of the
      other; ``mice_elephant`` sends ``elephant_size`` packets with
      probability ``elephant_frac``, else one, to a uniform destination.
    * The adversarial families, one packet a message: ``tornado`` sends
      every endpoint to the same slot of the leaf halfway around the
      leaf ranking; ``shift`` to ``(e + shift) mod S``; ``hotspot`` a
      ``hot_frac`` share of its messages to one of the first
      ``hot_count`` endpoints, the rest uniformly; ``bursty`` modulates
      a uniform source with a two-state (on-off) Markov chain per
      endpoint: ``burst_load`` while on, bursts of ``burst_len`` slots
      on average, and a long-run offered load of ``load``.
    * ``arrival``: the open-loop serving source.  ``process`` picks the
      generator: ``poisson`` (a single-packet arrival with probability
      ``load`` a slot), ``pareto`` (bounded-Pareto batches of shape
      ``pareto_alpha`` and cap ``pareto_cap``, the arrival probability
      divided by the exact mean batch so that ``load`` is the offered
      packets a slot) or ``diurnal`` (poisson with the rate ``load * (1
      + diurnal_amp * sin(2 pi slot / diurnal_period))``).  Arrivals
      queue in a per-endpoint FIFO of ``arr_depth`` batches and are
      dropped (``arr_drop``) when it is full; an idle endpoint starts
      its head batch as a message to a uniform destination, its packets
      born at the batch's arrival slot (``msg_birth``), so latency
      counts the source queueing.
    * ``all2all``: each endpoint sends ``rounds`` single-packet messages
      to ``(e + r + 1) mod S``, free-running (no round synchronization).
    * ``phase``: each endpoint sends ``phase_packets`` packets to
      ``partner[e]``, a state row the caller sets (the host-loop idiom).
    * ``program``: a compiled workload program of ``n_phases`` phases run
      by the phase scheduler under ``schedule`` (``"barrier"`` replays
      the host loop bitwise; ``"window"`` lets endpoints run ``window``
      phases ahead of the globally-completed phase count).  The
      program's arrays live in the *state* (``make_program_state``);
      only its shape and schedule live here.
    """
    pattern: str = "uniform"
    load: float = 1.0
    rounds: int = 0
    phase_packets: int = 0
    elephant_frac: float = 0.1   # fraction of messages that are elephants
    elephant_size: int = 16
    # adversarial Bernoulli knobs
    shift: int = 1               # shift: dst = (e + shift) mod S
    hot_frac: float = 0.1        # hotspot: fraction of incast messages
    hot_count: int = 1           # hotspot: number of hot endpoints
    burst_len: float = 8.0       # bursty: mean ON duration (slots)
    burst_load: float = 1.0      # bursty: injection probability while ON
    # open-loop arrival source ("arrival" pattern) knobs
    process: str = "poisson"     # poisson | pareto | diurnal
    pareto_alpha: float = 1.5    # bounded-Pareto shape (> 1)
    pareto_cap: int = 64         # bounded-Pareto batch-size cap (packets)
    diurnal_amp: float = 0.5     # relative rate-modulation amplitude [0,1]
    diurnal_period: int = 512    # modulation period (slots, >= 2)
    arr_depth: int = 8           # per-endpoint pending-batch FIFO depth
    # compiled workload program (schedule shape; arrays live in the state)
    n_phases: int = 0
    schedule: str = "barrier"    # "barrier" | "window"
    window: int = 1              # lookahead depth for schedule="window"

    def __post_init__(self):
        check_engine_pattern(self.pattern)
        if self.pattern == "arrival" and self.process not in ARRIVAL_PATTERNS:
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             f"expected one of {ARRIVAL_PATTERNS}")


class Simulator:
    """The switch model on one device.

    ``device=None`` means the card; with no card it raises (pass
    ``device="cpu"`` to run the plain versions of the kernels).
    ``failures`` (a ``FailureSchedule``, validated against the topology)
    arms the failure branch when it holds events; the ``failures``
    attribute may be reassigned later (``degrade_sweep`` swaps in each
    rate's schedule), but whether the branch is armed is fixed here.
    """

    def __init__(self, tables: RoutingTables, cfg: SimConfig,
                 failures=None, *, device=None):
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; expected one "
                             f"of {POLICIES}")
        self.device = resolve_device(device)
        self._pt = cfg.threefry_partitionable
        topo = tables.topo
        self.tables, self.cfg = tables, cfg
        self.failures = failures
        self.has_failures = failures is not None and len(failures.events) > 0
        if failures is not None:
            failures.validate(topo)
        self.N = topo.n_switches
        self.P = topo.max_ports
        self.V = cfg.vcs
        self.Q = cfg.queue_depth
        self.QE = cfg.endpoint_queue
        self.n1 = topo.n_leaves
        self.d_leaf = topo.endpoints_per_leaf
        self.S = topo.n_endpoints
        self.NQ = self.N * self.P * self.V
        self.pool = cfg.pool or int(min(2_000_000, max(1 << 14, self.S * 6)))

        # bit-packing bounds: p_sd packs two leaf ranks into 16 bits each,
        # p_bh keeps hops in the low byte; flat index spaces must fit int32
        if not self.n1 < (1 << 16):
            raise ValueError("leaf rank overflows the p_sd packing")
        if not cfg.max_hops < 255:
            raise ValueError("hop count overflows the p_bh packing")
        if not self.n1 * self.N < (1 << 31):
            raise ValueError("mask-table row index overflows int32")
        if not self.NQ * max(self.Q, cfg.out_queue) < (1 << 31):
            raise ValueError("flat queue-buffer index overflows int32")
        if not self.pool < (1 << 31) - 1:
            raise ValueError("pool index overflows int32")
        if not (tables.dist_leaf >= 0).all():
            raise ValueError("disconnected topology")

        dev = self.device
        nbrs = np.asarray(topo.nbrs)
        nbr_port = np.asarray(topo.nbr_port)
        valid = nbrs >= 0
        self.leaf_ids = torch.as_tensor(topo.leaf_ids, dtype=_I32,
                                        device=dev)
        # int16 distances, flat [N1 * N]; polarized's hop budget reads them.
        # A copy: apply_failures rewrites the tables' rows in place
        self.dist = torch.as_tensor(tables.dist_leaf, dtype=torch.int16,
                                    device=dev).reshape(-1).clone()
        self.W = (self.P + 31) // 32
        self.min_mask, self.away_mask = self._build_device_masks(tables)
        self._w_idx = torch.as_tensor(np.arange(self.P) // 32,
                                      dtype=torch.int64, device=dev)
        self._b_idx = torch.as_tensor(np.arange(self.P) % 32, dtype=_I32,
                                      device=dev)
        self._v_ids = torch.arange(self.V, dtype=_I32, device=dev)
        self._q_ids = torch.arange(self.Q, dtype=_I32, device=dev)
        self._oq_ids = torch.arange(cfg.out_queue, dtype=_I32, device=dev)
        self._qe_ids = torch.arange(self.QE, dtype=_I32, device=dev)
        self._e = torch.arange(self.S, dtype=_I32, device=dev)
        # a fresh free list, written back at a barrier crossing
        self._fl_fresh = torch.arange(self.pool, dtype=_I32, device=dev)
        self._phase_ids = {}        # n_phases -> arange, for the scheduler
        self._arr_ids = {}          # arr_depth -> arange, for the FIFOs
        self._pareto_thr = {}       # (alpha, cap) -> batch-size thresholds
        self._rep_offsets = {}      # (R, size, ndim) -> replica offsets
        # link phase: downstream input queue of every (switch, port, VC)
        # and the port validity mask (ports with no link stay masked)
        nb0 = np.maximum(nbrs, 0).reshape(-1).astype(np.int64)
        nbp = np.maximum(nbr_port, 0).reshape(-1).astype(np.int64)
        self._link_dq = torch.as_tensor(
            (nb0 * self.P + nbp)[:, None] * self.V
            + np.arange(self.V)[None, :], device=dev)            # [N*P, V]
        # the switch each (switch, port) sends to, 0 where no link
        self._link_nb = torch.as_tensor(nb0, dtype=_I32, device=dev)
        self._valid = torch.as_tensor(valid.reshape(-1), device=dev)
        self._init_requester_geometry(topo)

    def _build_device_masks(self, tables: RoutingTables):
        """Device mask tables ``[N1*N, W]`` as int32 views of the uint32
        words, packed on the device from the int16 distances in leaf
        blocks of ``tables.leaf_block`` rows.  Only Polarized and
        degraded keep the away bits."""
        n, n1, w = self.N, self.n1, self.W
        need_away = self.cfg.policy in ("polarized", "degraded")
        nbrs = np.asarray(tables.topo.nbrs)
        valid = torch.as_tensor(nbrs >= 0, device=self.device)
        nbr_safe = torch.as_tensor(np.maximum(nbrs, 0).astype(np.int64),
                                   device=self.device)
        dist = self.dist.reshape(n1, n)
        min_mask = torch.empty((n1 * n, w), dtype=_I32, device=self.device)
        away_mask = torch.empty_like(min_mask) if need_away else None
        for lo in range(0, n1, tables.leaf_block):
            hi = min(lo + tables.leaf_block, n1)
            min_b, away_b = pack_mask_block(dist[lo:hi], valid, nbr_safe,
                                            away=need_away)
            min_mask[lo * n:hi * n] = min_b.reshape(-1, w)
            if need_away:
                away_mask[lo * n:hi * n] = away_b.reshape(-1, w)
        return min_mask, away_mask

    def _init_requester_geometry(self, topo) -> None:
        """Static per-requester index tables for the crossbar.

        Requester rows are ``[N*P network inputs] ++ [S endpoint NICs]``;
        everything here depends only on the topology.
        """
        N, P, V, S, d = self.N, self.P, self.V, self.S, self.d_leaf
        dev = self.device
        nbrs = np.asarray(topo.nbrs)
        nbr_port = np.asarray(topo.nbr_port)
        leaf_ids = np.asarray(topo.leaf_ids)

        cur_net = np.repeat(np.arange(N, dtype=np.int32), P)
        cur_ep = leaf_ids[np.arange(S, dtype=np.int32) // d]
        cur = np.concatenate([cur_net, cur_ep])                  # [NR]
        self.NR = cur.shape[0]
        self.cur = torch.as_tensor(cur, dtype=_I32, device=dev)
        # the arbitration kernel's geometry: each leaf's first NIC row and
        # each output port's downstream input queues
        nic_first, dq_base = flat_rows_geometry(nbrs, nbr_port, leaf_ids, d,
                                                V)
        self._nic_first = torch.as_tensor(nic_first, device=dev)
        self._dq_base = torch.as_tensor(dq_base, device=dev)      # [N*P]
        # UGAL's occupancy at each NIC's switch: the flat qlen index of
        # VC 0 of the downstream input queue of each port.  The reference
        # leaves an unlinked port's nbr_port at -1 (index -V, which jax
        # wraps); clamping it to 0 reads another queue, and either value
        # is masked out, since an unlinked port has no min_mask bit
        if self.cfg.policy == "ugal":
            sw = leaf_ids[np.arange(S, dtype=np.int32) // d]
            self._ugal_occ_idx = torch.as_tensor(
                (np.maximum(nbrs, 0)[sw] * P + np.maximum(nbr_port, 0)[sw])
                * V, dtype=torch.int64, device=dev)              # [S, P]
        # the dense per-switch layout of the TPU kernel's interface
        # (kernels.switch_arb.ops.switch_arbitrate_flat), off the main
        # path: row r of switch n is net in-port r (r < P) or NIC slot
        # r - P
        self.R_max = P + d
        net_rows = cur_net.astype(np.int64) * self.R_max + np.tile(
            np.arange(P, dtype=np.int64), N)
        ep_rows = (cur_ep.astype(np.int64) * self.R_max + P
                   + np.arange(S, dtype=np.int64) % d)
        self._row_of = torch.as_tensor(np.concatenate([net_rows, ep_rows]),
                                       device=dev)
        # link reversal: input port (n', p') is fed by exactly one output
        # port, so receives invert sends with a gather
        rev = (np.maximum(nbrs, 0) * P + np.maximum(nbr_port, 0))
        self._rev_idx = torch.as_tensor(rev.reshape(-1).astype(np.int64),
                                        device=dev)

    # ------------------------------------------------------------------ #
    def init_state(self) -> dict:
        """The empty fabric: all queues empty, every pool slot free."""
        dev, pool = self.device, self.pool

        def Z(*shape):
            return torch.zeros(shape, dtype=_I32, device=dev)

        def full(shape, v):
            return torch.full(shape, v, dtype=_I32, device=dev)

        def pooled(x, key):
            pad = torch.full((1,), POOL_KEYS[key], dtype=_I32, device=dev)
            return torch.cat([x, pad])

        OQ = self.cfg.out_queue
        return {
            "qbuf": full((self.NQ, self.Q), -1),
            "qhead": Z(self.NQ), "qlen": Z(self.NQ),
            "oq_buf": full((self.NQ, OQ), -1),
            "oq_head": Z(self.NQ), "oq_len": Z(self.NQ),
            "eq_buf": full((self.S, self.QE), -1),
            "eq_head": Z(self.S), "eq_len": Z(self.S),
            # ring-buffer free list of packet ids (all free) and the
            # bit-packed per-packet attributes: p_sd = src_leaf << 16 |
            # dst_leaf, p_bh = born_slot << 8 | hops
            "fl_buf": pooled(torch.arange(pool, dtype=_I32, device=dev),
                             "fl_buf"),
            "fl_head": Z(), "fl_len": torch.tensor(pool, dtype=_I32,
                                                   device=dev),
            "p_sd": pooled(Z(pool), "p_sd"),
            "p_mid": pooled(full((pool,), -1), "p_mid"),
            "p_bh": pooled(Z(pool), "p_bh"),
            "msg_rem": Z(self.S), "msg_dst": Z(self.S), "prog": Z(self.S),
            "ejected": Z(), "created": Z(), "hop_sum": Z(),
            "pool_stall": Z(),
            "lat_hist": Z(self.cfg.hist_bins),
            "slot": Z(),
            "key": prng.prng_key(self.cfg.seed, device=dev),
        } | (self._failure_state() if self.has_failures else {})

    def _failure_state(self) -> dict:
        """The armed state's routing tables (copies of the simulator's, so
        that ``update_tables`` never reaches them), the liveness masks
        (all up) and the ``fail_drop`` counter."""
        st = {"tbl_min": self.min_mask.clone()}
        if self.away_mask is not None:
            st["tbl_away"] = self.away_mask.clone()
        st["tbl_dist"] = self.dist.clone()
        st["link_up"] = self._valid.clone()
        st["switch_up"] = torch.ones(self.N, dtype=torch.bool,
                                     device=self.device)
        st["fail_drop"] = torch.zeros((), dtype=_I32, device=self.device)
        return st

    def _check_traffic(self, traffic: Traffic) -> None:
        """The reference's checks of the adversarial knobs against this
        fabric, with its messages.  Also: a ``shift`` must fit in int32,
        the type of the endpoint ids it is added to (the reference's jax
        refuses a larger Python int when the step runs)."""
        if traffic.pattern == "shift" and traffic.shift % self.S == 0:
            raise ValueError(
                f"shift offset {traffic.shift} is 0 mod {self.S} endpoints "
                "(every message would be self-addressed)")
        if traffic.pattern == "shift" and not (
                -(1 << 31) <= traffic.shift < (1 << 31)):
            raise OverflowError(f"shift offset {traffic.shift} does not fit "
                                "in int32, the type of the endpoint ids")
        if traffic.pattern == "tornado" and self.n1 < 2:
            raise ValueError("tornado needs at least 2 leaves")
        if traffic.pattern == "hotspot" and traffic.hot_count > self.S:
            raise ValueError(
                f"hot_count {traffic.hot_count} > endpoints {self.S} "
                "(out-of-range destinations would silently clamp)")
        if traffic.pattern == "bursty":
            if traffic.load > traffic.burst_load:
                raise ValueError(
                    f"bursty load {traffic.load} exceeds burst_load "
                    f"{traffic.burst_load}: the long-run offered load can "
                    "never exceed the in-burst intensity")
            duty_max = traffic.burst_len / (traffic.burst_len + 1.0)
            if traffic.load > traffic.burst_load * duty_max:
                raise ValueError(
                    f"bursty duty cycle {traffic.load / traffic.burst_load:.3f} "
                    f"is unreachable: with mean burst length "
                    f"{traffic.burst_len} the ON fraction tops out at "
                    f"{duty_max:.3f} (even at p_on = 1), so the long-run "
                    "offered load would silently undershoot `load` — "
                    "raise burst_len or burst_load")
        if traffic.pattern == "arrival":
            check_arrival(traffic.process, traffic.load,
                          pareto_alpha=traffic.pareto_alpha,
                          pareto_cap=traffic.pareto_cap,
                          diurnal_amp=traffic.diurnal_amp,
                          diurnal_period=traffic.diurnal_period,
                          arr_depth=traffic.arr_depth)

    def make_state(self, traffic: Traffic, seed: int = 0) -> dict:
        """A fresh state; a non-zero ``seed`` is folded into the key of
        ``cfg.seed`` (seed 0 keeps the plain key), as in the reference.
        ``rep`` adds its endpoint permutation ``perm`` and ``rsp`` its leaf
        permutation ``sigma``, drawn by numpy from ``seed`` as the
        reference draws them; ``bursty`` adds each endpoint's on-off
        state ``burst`` (all off); ``phase`` a zero ``partner`` row for
        the caller to set; ``arrival`` the empty FIFOs (``arr_times`` and
        ``arr_sizes`` [S, arr_depth], ``arr_head``, ``arr_len``), each
        endpoint's ``msg_birth`` and the ``arrived`` and ``arr_drop``
        counters."""
        self._check_traffic(traffic)
        st = self.init_state()
        rng = np.random.default_rng(seed)
        if traffic.pattern == "rep":
            st["perm"] = torch.as_tensor(
                rng.permutation(self.S).astype(np.int32), device=self.device)
        if traffic.pattern == "rsp":
            st["sigma"] = torch.as_tensor(
                rng.permutation(self.n1).astype(np.int32), device=self.device)
        if traffic.pattern == "bursty":
            st["burst"] = torch.zeros(self.S, dtype=_I32, device=self.device)
        if traffic.pattern == "phase":
            st["partner"] = torch.zeros(self.S, dtype=_I32,
                                        device=self.device)
        if traffic.pattern == "arrival":
            D, dev = traffic.arr_depth, self.device
            for k, shape in (("arr_times", (self.S, D)),
                             ("arr_sizes", (self.S, D)),
                             ("arr_head", (self.S,)), ("arr_len", (self.S,)),
                             ("msg_birth", (self.S,)), ("arrived", ()),
                             ("arr_drop", ())):
                st[k] = torch.zeros(shape, dtype=_I32, device=dev)
        if seed:
            st["key"] = prng.fold_in(st["key"], seed)
        return st

    # ------------------------------------------------------------------ #
    # replicas: a batched state carries a leading [R] axis on every
    # per-replica entry; the step works on batched states only (a scalar
    # run goes through one-replica views at its entry and exit)
    # ------------------------------------------------------------------ #
    def make_batch_state(self, traffic: Traffic, seeds) -> dict:
        """``make_state`` of each seed, stacked on a leading replica axis:
        replica ``i`` is exactly ``make_state(traffic, seeds[i])``, its
        key and its seed-drawn permutations included."""
        states = [self.make_state(traffic, int(s)) for s in seeds]
        if not states:
            raise ValueError("a batched state needs at least one seed")
        return {k: torch.stack([s[k] for s in states]) for k in states[0]}

    @staticmethod
    def _batched(st: dict):
        """``(batched view of st, whether st is scalar)``.  A scalar state
        runs as one replica through ``unsqueeze(0)`` views (the program
        arrays of ``PROG_SHARED`` are unbatched either way);
        :func:`_unbatch` writes the entries back.  The entries the step
        scatters into in place through a flat view are made contiguous
        (a no-op for the states this module makes)."""
        scalar = not st["ejected"].ndim
        b = ({k: v if k in PROG_SHARED else v.unsqueeze(0)
              for k, v in st.items()} if scalar else st)
        for k in _IN_PLACE:
            b[k] = b[k].contiguous()
        return b, scalar

    def _offsets(self, reps: int, size: int, ndim: int) -> torch.Tensor:
        """int64 ``[R, 1, ...]`` (``ndim`` axes): replica r's first flat
        index in a ``[R, size]`` layout."""
        key = (reps, size, ndim)
        off = self._rep_offsets.get(key)
        if off is None:
            off = self._rep_offsets[key] = (
                torch.arange(reps, dtype=torch.int64, device=self.device)
                * size).reshape((reps,) + (1,) * (ndim - 1))
        return off

    def _flat(self, idx: torch.Tensor, size: int) -> torch.Tensor:
        """``idx`` [R, ...] (indices into each replica's ``size`` flat
        elements) as indices into the flat ``[R * size]`` layout; at one
        replica the indices themselves."""
        reps = idx.shape[0]
        return idx if reps == 1 else idx + self._offsets(reps, size,
                                                          idx.ndim)

    def _take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``x[r].flatten()[idx[r]]`` for every replica r of a
        contiguous ``x`` [R, ...]."""
        return x.reshape(-1)[self._flat(idx, x[0].numel())]

    def _phase_rows(self, st, k: str, ph: torch.Tensor) -> torch.Tensor:
        """Row ``ph[r]`` of program array ``k`` for every replica r: one
        shared copy (``PROG_SHARED``) or, in a caller-built state that
        stacked it, replica r's own (told apart by ``ndim``)."""
        x = st[k]
        if x.ndim == PROG_SHARED[k]:
            return x.index_select(0, ph)
        reps, n = x.shape[:2]
        return x.reshape((reps * n,) + x.shape[2:]).index_select(
            0, ph + self._offsets(reps, n, 1))

    def _prog_take(self, st, k: str, idx: torch.Tensor) -> torch.Tensor:
        """Program array ``k`` [n_phases, S] at flat index ``idx`` [R, S]
        of every replica, shared or stacked."""
        x = st[k]
        if x.ndim == PROG_SHARED[k]:
            return x.reshape(-1)[idx]
        return self._take(x, idx)

    # ------------------------------------------------------------------ #
    def _port_bits(self, table, t_lr, cur):
        """[..., P] bool port mask: one word gather per requester and a
        bit test (exact on the int32 views of the uint32 words).  A
        state's tables ``[R, N1*N, W]`` are read through each replica's
        offset (``_flat``)."""
        idx = t_lr * self.N + cur
        if table.ndim == 3:
            words = table.reshape(-1, self.W)[self._flat(idx,
                                                         table.shape[1])]
        else:
            words = table[idx]                                   # [., W]
        return ((words[..., self._w_idx] >> self._b_idx) & 1).bool()

    @staticmethod
    def _mean_msg(t: Traffic) -> float:
        if t.pattern == "mice_elephant":
            return ((1 - t.elephant_frac) * 1.0
                    + t.elephant_frac * t.elephant_size)
        return 1.0

    def _inject(self, st, key, traffic: Traffic):
        """Start messages + push one packet per eligible endpoint, in
        every replica of the batched state ``st``."""
        S, d, pool, pt = self.S, self.d_leaf, self.pool, self._pt
        e = self._e
        k1, k2, k3, k4 = prng.split(key, 4, partitionable=pt).unbind(-2)

        idle = st["msg_rem"] == 0                                  # [R, S]
        pat = traffic.pattern
        size = 1
        burst_new = None
        arrival = None
        if pat == "all2all":
            start = idle & (st["prog"] < traffic.rounds)
            dst = (e + st["prog"] + 1) % S
        elif pat == "phase":
            start = idle & (st["prog"] < 1)
            dst = st["partner"]
            size = traffic.phase_packets
        elif pat == "program":
            NP = traffic.n_phases
            if traffic.schedule == "window":
                # st["prog"] is each endpoint's phase pointer; an endpoint
                # may start its phase-p message once p is within window
                # of the count of completed phases (a count, not a prefix)
                ncomp = (st["phase_done"] >= 0).sum(-1, dtype=_I32)
                pe = st["prog"]
                start = idle & (pe < (ncomp + traffic.window).clamp(
                    max=NP)[:, None])
                idx = pe.clamp(0, NP - 1).long() * S + e
                dst = self._prog_take(st, "prog_partner", idx)
                size = self._prog_take(st, "prog_packets", idx)
            else:
                # barrier: one message per endpoint per phase, the rows of
                # the running phase (an index_select: no host sync)
                ph = st["phase"].clamp(max=NP - 1)
                start = (idle & (st["prog"] < 1)
                         & (st["phase"] < NP)[:, None])
                dst = self._phase_rows(st, "prog_partner", ph)
                size = self._phase_rows(st, "prog_packets", ph)
        elif pat == "arrival":
            start, dst, size, arrival = self._arrive(st, traffic, idle, k1,
                                                     k2, k3)
        else:   # the Bernoulli families
            # the reference compares each uniform draw against the float32
            # rounding of its threshold (jax's weakly typed Python floats)
            u = prng.uniform(k1, (S,), partitionable=pt)
            if pat == "bursty":
                # two-state Markov (on-off) modulation: the idle -> burst
                # rate is set so that the long-run offered load is load;
                # the thresholds in float64 as the reference computes them
                rho = min(traffic.load / traffic.burst_load, 0.999)
                p_off = 1.0 / max(traffic.burst_len, 1.0)
                p_on = min(1.0, p_off * rho / max(1.0 - rho, 1e-9))
                ka, kb = prng.split(k3, 2, partitionable=pt).unbind(-2)
                stay = (prng.uniform(ka, (S,), partitionable=pt)
                        >= _f32(p_off))
                rise = prng.uniform(kb, (S,), partitionable=pt) < _f32(p_on)
                on = torch.where(st["burst"] > 0, stay, rise)
                burst_new = on.to(_I32)
                start = idle & on & (u < _f32(traffic.burst_load))
            else:
                start = idle & (u < _f32(traffic.load
                                         / self._mean_msg(traffic)))
            if pat in ("uniform", "mice_elephant", "bursty"):
                dst = prng.randint(k2, (S,), 0, S, partitionable=pt)
            elif pat == "rep":
                dst = st["perm"]
            elif pat == "rsp":
                dst = st["sigma"][:, e // d] * d + e % d
            elif pat == "bu":   # the two halves exchange uniformly
                half = S // 2
                r = prng.randint(k2, (S,), 0, half, partitionable=pt)
                dst = torch.where(e < half, half + r, r % half)
            elif pat == "tornado":
                # every leaf sends to the same slot of the leaf halfway
                # around the leaf ranking
                n1 = self.n1
                dst = ((e // d + n1 // 2) % n1) * d + e % d
            elif pat == "shift":
                # int32 arithmetic, wrapping as the reference's does; the
                # remainder takes the sign of S, as jnp's
                dst = (e + traffic.shift) % S
            else:   # hotspot: incast a share onto a few hot endpoints
                kh, ki = prng.split(k3, 2, partitionable=pt).unbind(-2)
                hot = (prng.uniform(kh, (S,), partitionable=pt)
                       < _f32(traffic.hot_frac))
                dst = torch.where(
                    hot, prng.randint(ki, (S,), 0, traffic.hot_count,
                                      partitionable=pt),
                    prng.randint(k2, (S,), 0, S, partitionable=pt))
            if pat == "mice_elephant":
                eleph = (prng.uniform(k3, (S,), partitionable=pt)
                         < _f32(traffic.elephant_frac))
                size = torch.where(eleph, traffic.elephant_size, 1).to(_I32)

        msg_rem = torch.where(start, size, st["msg_rem"])
        msg_dst = torch.where(start, dst, st["msg_dst"])
        prog = st["prog"] + start.to(_I32)

        # one packet per endpoint with pending message + NIC room
        want = (msg_rem > 0) & (st["eq_len"] < self.QE)
        src_lr = e // d
        dst_lr = msg_dst // d
        local = src_lr == dst_lr
        # same-leaf fast path: delivered without entering the network
        deliver_local = want & local
        want_net = want & ~local

        # free-list pop: requester of rank r takes the r-th ring entry;
        # requesters past the free count get -1 (a pool stall)
        rank = torch.cumsum(want_net.to(_I32), -1, dtype=_I32) - 1
        ok = want_net & (rank < st["fl_len"][:, None])
        slot_idx = (st["fl_head"][:, None] + rank.clamp(min=0)) % pool
        pid = torch.where(ok, self._take(st["fl_buf"], slot_idx), -1)
        n_pop = ok.sum(-1, dtype=_I32)

        # non-injectors write into the pad slot at index pool
        widx = self._flat(torch.where(ok, pid.clamp(min=0), pool), pool + 1)
        if burst_new is not None:
            st["burst"] = burst_new
        if arrival is not None:
            st.update(arrival)
        st["fl_head"] = (st["fl_head"] + n_pop) % pool
        st["fl_len"] = st["fl_len"] - n_pop
        st["p_sd"].reshape(-1).index_put_((widx,), (src_lr << 16) | dst_lr)
        if self.cfg.policy in _VALIANT_POLICIES:
            st["p_mid"].reshape(-1).index_put_((widx,), self._intermediate(
                st, k4, src_lr, dst_lr))
        # arrival packets are born at their batch's arrival slot, so the
        # source queueing shows in the latency histogram
        born = (st["msg_birth"] if arrival is not None
                else st["slot"][:, None].expand(-1, S))
        st["p_bh"].reshape(-1).index_put_((widx,), born << 8)
        # push into the NIC queue (dense one-hot write, one row each)
        pos = (st["eq_head"] + st["eq_len"]) % self.QE
        slot_hot = ok[..., None] & (self._qe_ids == pos[..., None])
        st["eq_buf"] = torch.where(slot_hot, pid.clamp(min=0)[..., None],
                                   st["eq_buf"])
        st["eq_len"] = st["eq_len"] + ok.to(_I32)

        consumed = ok | deliver_local
        st["msg_rem"] = msg_rem - consumed.to(_I32)
        st["msg_dst"] = msg_dst
        st["prog"] = prog
        n_local = deliver_local.sum(-1, dtype=_I32)
        st["created"] = st["created"] + ok.sum(-1, dtype=_I32) + n_local
        st["ejected"] = st["ejected"] + n_local
        st["pool_stall"] = st["pool_stall"] + (want_net & ~ok).sum(
            -1, dtype=_I32)
        if arrival is not None:
            # local deliveries too count from the batch's arrival slot
            bins = self.cfg.hist_bins
            lat = (st["slot"][:, None] - st["msg_birth"] + 1).clamp(
                0, bins - 1)
            # index_add_ (atomic adds); index_put_(accumulate=True) sorts
            # its indices on the card and waits for the device
            st["lat_hist"].reshape(-1).index_add_(
                0, self._flat(torch.where(deliver_local, lat, 0),
                              bins).reshape(-1),
                deliver_local.to(_I32).reshape(-1))
        else:
            st["lat_hist"][:, 1] += n_local
        return st

    def _arrive(self, st, traffic: Traffic, idle, k1, k2, k3):
        """The open-loop source of ``Traffic("arrival")`` in every
        replica: draw this slot's arrivals (at most one batch an
        endpoint), push them into the FIFOs (a full FIFO drops the
        batch), and let the idle endpoints pop their head batch (one that
        arrived this slot too).  Returns ``(start, dst, size, updates)``,
        the updates being the FIFO state, ``msg_birth`` and the
        ``arrived`` / ``arr_drop`` counters, as the reference's."""
        S, D, pt = self.S, traffic.arr_depth, self._pt
        proc = traffic.process
        u = prng.uniform(k1, (S,), partitionable=pt)               # [R, S]
        batch = 1
        if proc == "poisson":
            arrive = u < _f32(traffic.load)
        elif proc == "pareto":
            # bounded-Pareto batches; the arrival probability is divided
            # by the exact mean batch, so the offered load is load
            alpha, cap = traffic.pareto_alpha, traffic.pareto_cap
            arrive = u < _f32(traffic.load / bounded_pareto_mean(alpha, cap))
            if cap > 1:
                thr = self._pareto_thr.get((alpha, cap))
                if thr is None:
                    thr = self._pareto_thr[(alpha, cap)] = \
                        arrivals.pareto_thresholds(alpha, cap, self.device)
                batch = arrivals.pareto_batch(
                    prng.uniform(k3, (S,), partitionable=pt), thr)
        else:   # diurnal: the rate of each replica's slot
            arrive = u < arrivals.diurnal_rate(
                st["slot"], traffic.load, traffic.diurnal_amp,
                traffic.diurnal_period)[:, None]
        if not torch.is_tensor(batch):
            batch = torch.ones_like(st["arr_len"])
        room = st["arr_len"] < D
        push = arrive & room
        tail = (st["arr_head"] + st["arr_len"]) % D
        ids = self._arr_ids.get(D)
        if ids is None:
            ids = self._arr_ids[D] = torch.arange(D, dtype=_I32,
                                                  device=self.device)
        hot = push[..., None] & (ids == tail[..., None])        # [R, S, D]
        arr_times = torch.where(hot, st["slot"][:, None, None],
                                st["arr_times"])
        arr_sizes = torch.where(hot, batch[..., None], st["arr_sizes"])
        arr_len = st["arr_len"] + push.to(_I32)
        start = idle & (arr_len > 0)
        head = self._e * D + st["arr_head"]
        size = self._take(arr_sizes, head).clamp(min=1)
        birth = self._take(arr_times, head)
        dst = prng.randint(k2, (S,), 0, S, partitionable=pt)
        return start, dst, size, {
            "arr_times": arr_times,
            "arr_sizes": arr_sizes,
            "arr_head": torch.where(start, (st["arr_head"] + 1) % D,
                                    st["arr_head"]),
            "arr_len": arr_len - start.to(_I32),
            "arrived": st["arrived"] + torch.where(push, batch, 0).sum(
                -1, dtype=_I32),
            "arr_drop": st["arr_drop"] + torch.where(
                arrive & ~room, batch, 0).sum(-1, dtype=_I32),
            "msg_birth": torch.where(start, birth, st["msg_birth"]),
        }

    def _intermediate(self, st, key, src_lr, dst_lr):
        """Each endpoint's intermediate leaf rank, -1 for none: a uniform
        leaf for ``valiant``; for ``ugal`` that leaf only where the
        shortest-queue estimate times the hop count via it is smaller
        (strictly) than the minimal route's, from the occupancies of VC 0
        at the source switch.  Armed with failures, the state's tables
        and the source switch's live ports: the products in float32, as
        the reference's (an ``UNREACHABLE`` distance would wrap the int32
        score), and the int16 ``d_val`` sum wraps as jnp's does."""
        N = self.N
        mid_lr = prng.randint(key, (self.S,), 0, self.n1,
                              partitionable=self._pt)          # [R, S]
        if self.cfg.policy == "valiant":
            return mid_lr
        sw = self.leaf_ids[src_lr]
        occ0 = st["qlen"][:, self._ugal_occ_idx]                # [R, S, P]
        if self.has_failures:
            R = st["slot"].shape[0]
            live_sw = st["link_up"].reshape(R, N, self.P)[:, sw]  # [R,S,P]
            tmin = st["tbl_min"]

            def dist(idx):
                return self._take(st["tbl_dist"], idx)
        else:
            live_sw, tmin = None, self.min_mask

            def dist(idx):
                return self.dist[idx]

        def best(t_lr):
            m = self._port_bits(tmin, t_lr, sw)
            if live_sw is not None:
                m = m & live_sw
            return torch.where(m, occ0, 1 << 20).amin(dim=-1)
        q_min, q_val = best(dst_lr), best(mid_lr)
        # int16 distances and their int16 sum; the products promote to
        # int32, as in the reference
        d_min = dist(dst_lr * N + sw)
        d_val = (dist(mid_lr * N + sw)
                 + dist(dst_lr * N + self.leaf_ids[mid_lr]))
        if self.has_failures:
            take_val = q_min.float() * d_min > q_val.float() * d_val
        else:
            take_val = q_min * d_min > q_val * d_val
        return torch.where(take_val, mid_lr, -1)

    # ------------------------------------------------------------------ #
    def _crossbar_round(self, st, key):
        """One crossbar sub-round: VC pre-arbitration, routing, output
        arbitration, input-queue -> output-queue moves, ejections."""
        N, P, V, Q = self.N, self.P, self.V, self.Q
        OQ, NP, pool = self.cfg.out_queue, self.N * self.P, self.pool
        R = st["slot"].shape[0]
        k_vc, k_tie, k_arb = prng.split(key, 3,
                                        partitionable=self._pt).unbind(-2)

        # ---- VC pre-arbitration: one candidate VC per (switch, in-port)
        # and that queue's head packet (-1: no candidate); the replicas'
        # switches go through as R*N switches ----
        vc_rand = prng.uniform(k_vc, (N, P, V), partitionable=self._pt)
        vc_sel, _has, net_pkt = vc_prearb(
            st["qlen"].reshape(R * N, P, V), vc_rand.reshape(R * N, P, V),
            st["qbuf"].reshape(R * self.NQ, Q), st["qhead"].reshape(-1))
        vc_sel = vc_sel.reshape(R, NP)
        net_pkt = net_pkt.reshape(R, NP)

        # endpoint (NIC) heads
        ep_head = self._take(st["eq_buf"], self._e * self.QE + st["eq_head"])
        ep_pkt = torch.where(st["eq_len"] > 0, ep_head, -1)

        # ---- unified requester table [R, NR] ----
        cur = self.cur                                             # [NR]
        pkt = torch.cat([net_pkt, ep_pkt], dim=-1)
        valid = pkt >= 0
        pkt0 = pkt.clamp(min=0)
        bh = self._take(st["p_bh"], pkt0)
        hops = bh & 0xFF
        sd = self._take(st["p_sd"], pkt0)
        t_lr = sd & 0xFFFF
        eject = valid & (cur == self.leaf_ids[t_lr])
        route = valid & ~eject
        pol = self.cfg.policy
        hf = self.has_failures
        if hf:
            # the state's tables; live_row gates every policy's candidate
            # ports to live ones (a dead switch's rows are all dead, so
            # its packets wait for a drop or a restore)
            tmin, taway = st["tbl_min"], st.get("tbl_away")
            live_row = st["link_up"].reshape(R, N, P)[:, cur]   # [R,NR,P]

            def dist(idx):
                return self._take(st["tbl_dist"], idx)
        else:
            tmin, taway = self.min_mask, self.away_mask

            def dist(idx):
                return self.dist[idx]
        if pol == "polarized":
            # Forward = away-from-s & toward-t, Expansion = away & away
            # (while d_cs < d_ct), Contraction = toward & toward (once
            # d_cs >= d_ct); d(n,t) = d(c,t) + away - toward
            s_lr = sd >> 16
            dn_t = self._port_bits(tmin, t_lr, cur)
            up_t = self._port_bits(taway, t_lr, cur)
            dn_s = self._port_bits(tmin, s_lr, cur)
            up_s = self._port_bits(taway, s_lr, cur)
            d_ct = dist(t_lr * N + cur)
            d_cs = dist(s_lr * N + cur)
            src_side = (d_cs < d_ct)[..., None]
            deroute = (up_s & up_t & src_side) | (dn_s & dn_t & ~src_side)
            d_nt = (d_ct[..., None] + up_t.to(torch.int16)
                    - dn_t.to(torch.int16))
            budget_ok = (hops[..., None] + 1 + d_nt) <= self.cfg.max_hops
            allowed = (up_s & dn_t) | (deroute & budget_ok)
        elif pol == "degraded":
            # layered recovery: the live toward ports while there are
            # any; with none left, a live away port (one layer up, two
            # hops more) within the hop budget.  On a pristine fabric the
            # fallback never fires: minimal_adaptive bit for bit
            toward = self._port_bits(tmin, t_lr, cur)
            away = self._port_bits(taway, t_lr, cur)
            if hf:
                toward = toward & live_row
                away = away & live_row
            d_ct = dist(t_lr * N + cur)
            no_min = ~toward.any(-1)
            budget_ok = (hops[..., None] + 2 + d_ct[..., None]
                         ) <= self.cfg.max_hops
            deroute = no_min[..., None] & away & budget_ok
            allowed = toward | deroute
        elif pol in _VALIANT_POLICIES:
            # minimal toward the intermediate leaf while there is one
            mid_lr = self._take(st["p_mid"], pkt0)
            tgt = torch.where(mid_lr >= 0, mid_lr, t_lr)
            allowed = self._port_bits(tmin, tgt, cur)
            deroute = torch.zeros_like(allowed)
        else:   # minimal_adaptive, ksp
            allowed = self._port_bits(tmin, t_lr, cur)
            deroute = torch.zeros_like(allowed)
        if hf and pol != "degraded":    # degraded gated its layers above
            allowed = allowed & live_row
        # the flight VC climbs with every hop under ugal / valiant, with
        # every up-down pass (two hops) under the others
        vc_hops = hops if pol in _VALIANT_POLICIES else hops // 2
        next_vc = vc_hops.clamp(max=V - 1)
        tie = prng.uniform(k_tie, (self.NR, P), partitionable=self._pt)
        rnd = prng.randint(k_arb, (self.NR,), 0, 1 << 8,
                           partitionable=self._pt)
        # one kernel for all replicas: congestion (local output queue +
        # downstream input queue for the flight VC), credit (room in the
        # local output queue), scores, first argmin and the segmented
        # output arbitration; ksp's random walk scores the tiebreak alone
        _port, win, seg = switch_arbitrate_rows(
            tie, allowed, deroute, route, rnd, next_vc, st["oq_len"],
            st["qlen"], nic_first=self._nic_first, dq_base=self._dq_base,
            d=self.d_leaf, penalty=float(self.cfg.deroute_penalty),
            out_queue=OQ, zero_occ=pol == "ksp")
        win = win > 0

        # ---- moves: input queue -> output queue ----
        # the winning priority word per output port is the inverted grant:
        # its low 23 bits are the unique flat requester index
        exist = seg >= 0                                           # [R, NP]
        wlo = torch.where(exist, seg & ((1 << 23) - 1), 0)
        win_pkt = self._take(pkt0, wlo)                            # [R, NP]
        win_vc = self._take(next_vc, wlo)
        push = (exist[..., None] & (win_vc[..., None] == self._v_ids)
                ).reshape(R, -1)
        pos = (st["oq_head"] + st["oq_len"]) % OQ                  # [R, NQ]
        slot_hot = push[..., None] & (self._oq_ids == pos[..., None])
        win_pkt_q = win_pkt[..., None].expand(R, NP, V).reshape(R, -1)
        st["oq_buf"] = torch.where(slot_hot, win_pkt_q[..., None],
                                   st["oq_buf"])
        st["oq_len"] = st["oq_len"] + push.to(_I32)

        # pops: winners + ejectors leave their input queues (each
        # (switch, in-port) pops at most its one pre-arbitrated VC)
        leave = win | eject
        pop = (leave[:, :NP, None] & (vc_sel[..., None] == self._v_ids)
               ).reshape(R, -1).to(_I32)                           # [R, NQ]
        st["qhead"] = (st["qhead"] + pop) % Q
        st["qlen"] = st["qlen"] - pop
        ep_leave = leave[:, NP:].to(_I32)
        st["eq_head"] = (st["eq_head"] + ep_leave) % self.QE
        st["eq_len"] = st["eq_len"] - ep_leave

        # ejections: free-list push (only network inputs eject) + stats
        ej_n = eject[:, :NP]
        erank = torch.cumsum(ej_n.to(_I32), -1, dtype=_I32) - 1
        fpos = (st["fl_head"][:, None] + st["fl_len"][:, None]
                + erank.clamp(min=0)) % pool
        st["fl_buf"].reshape(-1).index_put_(
            (self._flat(torch.where(ej_n, fpos, pool), pool + 1),),
            pkt0[:, :NP])
        st["fl_len"] = st["fl_len"] + ej_n.sum(-1, dtype=_I32)
        lat = (st["slot"][:, None] - (bh[:, :NP] >> 8) + 1).clamp(
            0, self.cfg.hist_bins - 1)
        st["lat_hist"].reshape(-1).index_add_(
            0, self._flat(torch.where(ej_n, lat, 0),
                          self.cfg.hist_bins).reshape(-1),
            ej_n.to(_I32).reshape(-1))
        st["ejected"] = st["ejected"] + eject.sum(-1, dtype=_I32)
        st["hop_sum"] = st["hop_sum"] + torch.where(eject, hops, 0).sum(
            -1, dtype=_I32)
        return st

    def _link_phase(self, st, key):
        """Move one packet per link: output-queue head -> downstream input
        queue (credit-checked), incrementing the packet's hop count."""
        N, P, V, Q = self.N, self.P, self.V, self.Q
        OQ, NP = self.cfg.out_queue, self.N * self.P
        R = st["slot"].shape[0]
        # one non-empty output VC per (switch, port) with downstream room,
        # by random priority: the masked argmax of VC pre-arbitration
        room = st["qlen"][:, self._link_dq] < Q                  # [R,NP,V]
        nonempty = st["oq_len"].reshape(R, NP, V) > 0
        link_ok = self._valid
        if self.has_failures:                  # no sends over dead links
            link_ok = link_ok & st["link_up"]                   # [R, NP]
        cand = nonempty & room & link_ok[..., None]
        rand = prng.uniform(key, (NP, V), partitionable=self._pt)
        # and the chosen queue's head packet; a non-sender's -1 clamps to
        # 0, which nothing reads (it adds 0 hops and is never pushed)
        vcs, send, head = vc_prearb(cand.to(_I32).reshape(R * N, P, V),
                                    rand.reshape(R * N, P, V),
                                    st["oq_buf"].reshape(R * self.NQ, OQ),
                                    st["oq_head"].reshape(-1))
        vcs = vcs.reshape(R, NP)
        send = send.reshape(R, NP) > 0
        pkt0 = head.reshape(R, NP).clamp(min=0)

        # each (switch, port) pops at most one VC; each input port receives
        # from exactly one static upstream output port (link reversal)
        pop = (send[..., None] & (vcs[..., None] == self._v_ids)
               ).reshape(R, -1).to(_I32)                            # [R, NQ]
        st["oq_head"] = (st["oq_head"] + pop) % OQ
        st["oq_len"] = st["oq_len"] - pop
        recv = send[:, self._rev_idx] & self._valid                 # [R, NP]
        recv_vc = vcs[:, self._rev_idx]
        recv_pkt = pkt0[:, self._rev_idx]
        push = (recv[..., None] & (recv_vc[..., None] == self._v_ids)
                ).reshape(R, -1)
        qpos = (st["qhead"] + st["qlen"]) % Q                       # [R, NQ]
        slot_hot = push[..., None] & (self._q_ids == qpos[..., None])
        recv_pkt_q = recv_pkt[..., None].expand(R, NP, V).reshape(R, -1)
        st["qbuf"] = torch.where(slot_hot, recv_pkt_q[..., None], st["qbuf"])
        st["qlen"] = st["qlen"] + push.to(_I32)
        # hop increment on the packed born|hops word (hops: low byte);
        # non-senders add 0
        st["p_bh"].reshape(-1).index_add_(
            0, self._flat(pkt0, self.pool + 1).reshape(-1),
            send.to(_I32).reshape(-1))
        if self.cfg.policy in _VALIANT_POLICIES:
            # a packet sent to its intermediate leaf's switch forgets it
            # (the others write the pad slot)
            mid_lr = self._take(st["p_mid"], pkt0)
            reached = send & (mid_lr >= 0) & (
                self._link_nb == self.leaf_ids[mid_lr.clamp(min=0)])
            st["p_mid"].reshape(-1).index_fill_(0, self._flat(
                torch.where(reached, pkt0, self.pool),
                self.pool + 1).reshape(-1).long(), -1)
        return st

    def _step(self, st, traffic: Traffic, chunk=None, max_slots=None):
        """One slot of every replica of the batched state ``st``."""
        key, k_inj, k_link, *k_xb = prng.split(
            st["key"], 3 + self.cfg.speedup,
            partitionable=self._pt).unbind(-2)
        st["key"] = key
        self._inject(st, k_inj, traffic)
        for r in range(self.cfg.speedup):
            self._crossbar_round(st, k_xb[r])
        self._link_phase(st, k_link)
        st["slot"] = st["slot"] + 1
        if traffic.pattern == "program":
            self._advance_program(st, traffic, chunk, max_slots)
        return st

    # ------------------------------------------------------------------ #
    # phase scheduler of the compiled workload programs
    # ------------------------------------------------------------------ #
    def _advance_program(self, st, traffic: Traffic, chunk, max_slots):
        """The phase bookkeeping of ``Traffic("program")`` after a slot,
        each replica on its own registers.

        ``barrier``: when the running phase's ejection target is met, or
        its ``max_slots`` budget is gone on a chunk boundary (the phase's
        own slot count, reset at every crossing, as the host loop sees
        it), record the crossing slot in ``phase_done``, bump ``phase``
        and set the transient state back to what a fresh state holds:
        the slot, ejection and message counters, the seven queue heads
        and lengths, the free list (its pad slot untouched) and the key
        (``key0``).  So each phase is bitwise a standalone host-loop
        ``run_completion`` and ``phase_done`` holds per-phase durations.
        ``pool_stall``, ``created``, ``hop_sum`` and ``lat_hist`` run on.

        ``window``: no resets; phase ``p`` is complete once the total
        deliveries reach ``expected_cum[p]`` (``phase_done`` holds
        cumulative completion slots).
        """
        NP = traffic.n_phases
        if traffic.schedule == "window":
            newly = (st["phase_done"] < 0) & (
                st["ejected"][:, None] >= st["prog_expected_cum"])
            st["phase_done"] = torch.where(newly, st["slot"][:, None],
                                           st["phase_done"])
            st["phase_ok"] = st["phase_ok"] | newly
            st["phase"] = (st["phase_done"] >= 0).sum(-1, dtype=_I32)
            return st

        ph = st["phase"]                                            # [R]
        active = ph < NP
        exp = self._phase_rows(st, "prog_expected", ph.clamp(max=NP - 1))
        natural = active & (st["ejected"] >= exp)
        crossed = natural
        if max_slots is not None:
            budget_gone = st["slot"] >= max_slots
            if chunk is not None:
                budget_gone = budget_gone & (st["slot"] % chunk == 0)
            crossed = natural | (active & budget_gone)
        pids = self._phase_ids.get(NP)
        if pids is None:
            pids = self._phase_ids[NP] = torch.arange(
                NP, dtype=_I32, device=self.device)
        hot = (pids == ph[:, None]) & crossed[:, None]
        st["phase_done"] = torch.where(hot, st["slot"][:, None],
                                       st["phase_done"])
        st["phase_ok"] = st["phase_ok"] | (hot & natural[:, None])
        st["phase"] = ph + crossed.to(_I32)
        # queue buffers keep stale ids (unreachable at length 0) and the
        # pool attributes stale packets (unreachable once the free list
        # is fresh), as behaviour-neutral as in a fresh state
        for k in _PHASE_RESET:
            x = st[k]
            st[k] = torch.where(
                crossed.reshape(crossed.shape + (1,) * (x.ndim - 1)), 0, x)
        fl = st["fl_buf"][:, :self.pool]
        fl.copy_(torch.where(crossed[:, None], self._fl_fresh, fl))
        st["fl_len"] = torch.where(crossed, self.pool, st["fl_len"])
        st["key"] = torch.where(crossed[:, None], st["key0"], st["key"])
        return st

    def run_chunk(self, st, traffic: Traffic, n_slots: int):
        """Advance ``n_slots`` slots in place; returns ``st``.  A scalar
        state runs as one replica, a batched state (``make_batch_state``)
        as all of its replicas at once."""
        b, scalar = self._batched(st)
        for _ in range(n_slots):
            self._step(b, traffic)
        if scalar:
            _unbatch(st, b)
        return st

    def run_chunk_batch(self, st, traffic: Traffic, n_slots: int):
        """``run_chunk`` of a batched state: every replica advances
        ``n_slots`` slots in the same steps."""
        if not st["ejected"].ndim:
            raise ValueError("run_chunk_batch takes a batched state "
                             "(make_batch_state); run_chunk takes both")
        return self.run_chunk(st, traffic, n_slots)

    # ------------------------------------------------------------------ #
    # measurement runs
    # ------------------------------------------------------------------ #
    def _throughput_window(self, st, traffic: Traffic, warm: int,
                           measure: int):
        """``warm`` then ``measure`` slots of ``st``; the window's
        ejections, hop sum and pool stalls and the total ejections as
        numpy arrays (0-d, or [R] for a batched state), in one
        transfer."""
        self.run_chunk(st, traffic, warm)
        base = {k: st[k].clone() for k in ("ejected", "hop_sum",
                                           "pool_stall")}
        self.run_chunk(st, traffic, measure)
        return torch.stack([st[k] - base[k] for k in base]
                           + [st["ejected"]]).cpu().numpy()

    def run_throughput(self, traffic: Traffic, warm: int = 200,
                       measure: int = 400, seed: int = 0) -> dict:
        st = self.make_state(traffic, seed)
        ej, hop, stall, total = (int(x) for x in self._throughput_window(
            st, traffic, warm, measure))
        return {
            "throughput": ej / (self.S * measure),
            "avg_hops": hop / max(ej, 1),
            "ejected": total,
            "pool_stall": stall,
            "state": st,
        }

    def run_throughput_batch(self, traffic: Traffic, seeds, warm: int = 200,
                             measure: int = 400, sharder=None) -> dict:
        """Batched ``run_throughput``: one step for all ``seeds``, each
        metric a per-replica ``[R]`` array; replica ``i`` is bitwise the
        scalar run with seed ``seeds[i]``.  A ``sharder`` (the
        reference's split of the replicas over devices) is not ported
        yet."""
        if sharder is not None:
            raise NotImplementedError(
                "run_throughput_batch(sharder=...) splits the replicas over "
                "devices, which is not ported yet (ROADMAP item 12)")
        st = self.make_batch_state(traffic, seeds)
        ej, hop, stall, total = self._throughput_window(st, traffic, warm,
                                                        measure)
        return {
            "throughput": ej / (self.S * measure),
            "avg_hops": hop / np.maximum(ej, 1),
            "ejected": total,
            "pool_stall": stall,
            "state": st,
        }

    def run_completion(self, traffic: Traffic, expected: int,
                       chunk: int = 128, max_slots: int = 100_000,
                       seed: int = 0, state: Optional[dict] = None,
                       budget_chunks: Optional[int] = None,
                       done=None) -> dict:
        """Run until ``expected`` packets are delivered (collectives).

        ``state`` (a state of this simulator, consumed) takes the place of
        a fresh ``make_state(traffic, seed)``: the host-loop idiom sets a
        ``Traffic("phase")`` state's ``partner`` row and runs it here; a
        batched state (``make_batch_state``) runs all its replicas.

        ``slots`` is the exact slot at which the ejection counter first
        reached ``expected``: a ``done`` tensor on the device records it,
        for each replica, after every step, with no sync.  Whether to run
        the next chunk of ``chunk`` slots is tested before each chunk,
        and only there (one host sync per chunk): the run goes on while
        any replica is not done and the largest slot is below
        ``max_slots``, so it ends on a chunk boundary, where
        ``pool_stall`` and ``state`` are read.  A replica that is not
        done by then reports the final slot and ``completed=False``.
        A batched state gives per-replica arrays.

        ``budget_chunks=B`` bounds one call to at most ``B`` chunks, the
        resumable runtime's segment (:mod:`repro_torch.runtime.resilient`).
        The result then also carries ``running`` (whether the next chunk
        would run) and ``done`` (numpy: 0-d for a scalar state, ``[R]``
        for a batched one), which the next segment takes back beside
        ``state``; a chain of bounded segments is bitwise one unbounded
        call.
        """
        # p_bh packs the born slot above the hop byte; past 2^23 slots the
        # shifted value would wrap int32 and corrupt latency measurement
        assert max_slots < (1 << 23), \
            "max_slots overflows the p_bh born-slot packing (< 2^23)"
        st = state if state is not None else self.make_state(traffic, seed)
        b, scalar = self._batched(st)
        if done is None:
            done = torch.full_like(b["ejected"], -1)
        else:
            done = torch.as_tensor(done).to(self.device, _I32).reshape(
                b["ejected"].shape).clone()
        chunks = 0
        while ((budget_chunks is None or chunks < budget_chunks)
               and bool(((done < 0).any() & (b["slot"].max() < max_slots)
                         ).item())):
            for _ in range(chunk):
                self._step(b, traffic)
                newly = (b["ejected"] >= expected) & (done < 0)
                done = torch.where(newly, b["slot"], done)
            chunks += 1
        if scalar:
            _unbatch(st, b)
        done, final, stall = torch.stack(
            [done, b["slot"], b["pool_stall"]]).cpu().numpy()
        slots = np.where(done >= 0, done, final)
        out = {"state": st}
        if budget_chunks is not None:
            out["done"] = done.reshape(()) if scalar else done
            out["running"] = bool((done < 0).any()
                                  and final.max() < max_slots)
        if scalar:
            return {"slots": int(slots[0]), "completed": bool(done[0] >= 0),
                    "pool_stall": int(stall[0]), **out}
        return {"slots": slots, "completed": done >= 0, "pool_stall": stall,
                **out}

    def run_completion_batch(self, traffic: Traffic, expected: int, seeds,
                             chunk: int = 128,
                             max_slots: int = 100_000) -> dict:
        """Batched ``run_completion`` over fresh states of ``seeds``."""
        return self.run_completion(
            traffic, expected, chunk=chunk, max_slots=max_slots,
            state=self.make_batch_state(traffic, seeds))

    def run_latency(self, traffic: Traffic, warm: int = 200,
                    measure: int = 600, seed: int = 0) -> dict:
        st = self.make_state(traffic, seed)
        self.run_chunk(st, traffic, warm)
        base = st["lat_hist"].clone()
        self.run_chunk(st, traffic, measure)
        hist = (st["lat_hist"] - base).cpu().numpy()
        return {"hist": hist, **percentiles(hist, LATENCY_QS)}

    def run_latency_batch(self, traffic: Traffic, seeds, warm: int = 200,
                          measure: int = 600) -> dict:
        """Batched ``run_latency``: per-replica histograms ``[R, bins]``
        and percentile arrays (``{"p0.5": [R floats], ...}``; NaN where a
        replica ejected nothing in the window)."""
        st = self.make_batch_state(traffic, seeds)
        self.run_chunk(st, traffic, warm)
        base = st["lat_hist"].clone()
        self.run_chunk(st, traffic, measure)
        hist = (st["lat_hist"] - base).cpu().numpy()
        per = [percentiles(row, LATENCY_QS) for row in hist]
        out = {"hist": hist}
        for q in LATENCY_QS:
            out[f"p{q}"] = np.asarray([p[f"p{q}"] for p in per])
        return out

    # ------------------------------------------------------------------ #
    # open-loop serving (Traffic("arrival"))
    # ------------------------------------------------------------------ #
    @staticmethod
    def arrival_backlog(st) -> int:
        """The packets still queued in the arrival FIFOs of a scalar
        ``Traffic("arrival")`` state (the live ring windows), on the host.
        With ``sum(msg_rem)`` (popped, not yet injected) it closes the
        open-loop ledger ``arrived == backlog + sum(msg_rem) +
        created``."""
        sizes = st["arr_sizes"].cpu().numpy()
        head = st["arr_head"].cpu().numpy()
        ln = st["arr_len"].cpu().numpy()
        D = sizes.shape[1]
        idx = (head[:, None] + np.arange(D)[None, :]) % D
        live = np.arange(D)[None, :] < ln[:, None]
        return int(np.take_along_axis(sizes, idx, 1)[live].sum())

    _SERVING_KEYS = ("lat_hist", "ejected", "arrived", "arr_drop",
                     "pool_stall")

    @staticmethod
    def _serving_metrics(m: dict, S: int, measure: int) -> dict:
        """Window deltas (numpy) -> the serving record: offered and
        delivered packets a slot an endpoint, source drops, pool stalls
        and the latency percentiles; per-replica arrays for a batched
        run (NaN percentiles where a replica delivered nothing)."""
        hist = m["lat_hist"]
        denom = float(S * measure)
        accepted = m["arrived"].astype(np.int64)
        dropped = m["arr_drop"].astype(np.int64)
        out = {
            "hist": hist,
            "offered": (accepted + dropped) / denom,
            "delivered": m["ejected"].astype(np.int64) / denom,
            "dropped": dropped,
            "pool_stall": m["pool_stall"].astype(np.int64),
        }
        if hist.ndim == 1:
            out.update(percentiles(hist, LATENCY_QS))
            out["offered"] = float(out["offered"])
            out["delivered"] = float(out["delivered"])
            out["dropped"] = int(out["dropped"])
            out["pool_stall"] = int(out["pool_stall"])
        else:
            per = [percentiles(row, LATENCY_QS) for row in hist]
            for q in LATENCY_QS:
                out[f"p{q}"] = np.asarray([p[f"p{q}"] for p in per])
        return out

    def _serving_window(self, st, traffic: Traffic, warm: int,
                        measure: int) -> dict:
        """``warm`` then ``measure`` slots of ``st``, and the serving
        record of the window's deltas."""
        self.run_chunk(st, traffic, warm)
        base = {k: st[k].clone() for k in self._SERVING_KEYS}
        self.run_chunk(st, traffic, measure)
        m = {k: (st[k] - base[k]).cpu().numpy() for k in base}
        return {**self._serving_metrics(m, self.S, measure), "state": st}

    def run_serving(self, traffic: Traffic, warm: int = 200,
                    measure: int = 600, seed: int = 0) -> dict:
        """Open-loop load-latency measurement: warm the arrival source,
        then measure offered against delivered rate, source drops and
        the latency histogram (from each batch's arrival slot, so source
        queueing counts) over ``measure`` slots."""
        if traffic.pattern != "arrival":
            raise ValueError(f"run_serving needs Traffic('arrival'), got "
                             f"{traffic.pattern!r}")
        return self._serving_window(self.make_state(traffic, seed), traffic,
                                    warm, measure)

    def run_serving_batch(self, traffic: Traffic, seeds, warm: int = 200,
                          measure: int = 600) -> dict:
        """Batched ``run_serving``: per-replica ``[R]`` arrays (percentile
        entries NaN where a replica delivered nothing in the window)."""
        if traffic.pattern != "arrival":
            raise ValueError(f"run_serving needs Traffic('arrival'), got "
                             f"{traffic.pattern!r}")
        return self._serving_window(self.make_batch_state(traffic, seeds),
                                    traffic, warm, measure)

    # ------------------------------------------------------------------ #
    # failures: live table updates and the resilience run
    # ------------------------------------------------------------------ #
    def update_tables(self, st, delta):
        """Write a :class:`repro_torch.core.routing.TableDelta` into the
        state's tables, in place, and set its liveness masks; scalar and
        batched states (every replica gets the same rows).  Returns
        ``st``."""
        if not self.has_failures:
            raise RuntimeError(
                "update_tables needs a Simulator built with a failure "
                "schedule (failures=...)")
        dev, n, w = self.device, self.N, self.W
        batched = st["ejected"].ndim == 1
        link_up = torch.as_tensor(delta.link_up.reshape(-1), device=dev)
        switch_up = torch.as_tensor(delta.switch_up, device=dev)
        if batched:
            r = st["ejected"].shape[0]
            link_up = link_up.expand(r, -1).clone()
            switch_up = switch_up.expand(r, -1).clone()
        st["link_up"], st["switch_up"] = link_up, switch_up
        k = delta.n_affected
        if k:
            rows = torch.as_tensor(
                (delta.leaf_rows.astype(np.int64)[:, None] * n
                 + np.arange(n)[None, :]).reshape(-1), device=dev)
            dim = 1 if batched else 0
            for key, vals in (("tbl_min", delta.min_rows),
                              ("tbl_away", delta.away_rows),
                              ("tbl_dist", delta.dist_rows)):
                if key not in st:
                    continue
                vals = vals.to(dev).reshape((k * n, w) if key != "tbl_dist"
                                            else (k * n,))
                if batched:
                    vals = vals.expand((st[key].shape[0],) + vals.shape)
                st[key].index_copy_(dim, rows, vals)
        return st

    def drop_dead_packets(self, st):
        """Free every packet stranded on a dead element (the ``drop``
        schedule policy): the whole input queues of dead switches, then
        the whole output queues feeding dead links, each from its head
        in queue order (the reference's order, which decides every later
        packet id).  The freed ids go to the tail of the free-list ring
        and ``fail_drop`` counts them; ``qlen`` / ``oq_len`` of those
        queues become 0, their heads and buffers stay.  Surgery on the
        host, of a scalar state, at failure slots only."""
        if st["ejected"].ndim != 0:
            raise ValueError("drop_dead_packets works on scalar states")
        N, P, V, dev = self.N, self.P, self.V, self.device
        link_up = st["link_up"].cpu().numpy().reshape(N, P)
        switch_up = st["switch_up"].cpu().numpy()
        # output queues die with their link (a dead switch's links are
        # all down); input queues only with their switch
        dead_out_q = np.repeat(~link_up.reshape(-1), V)            # [NQ]
        dead_in_q = np.repeat(~switch_up, P * V)                   # [NQ]
        freed = []

        def clear(buf, head, ln, depth, dead):
            for qi in np.nonzero(dead & (ln > 0))[0]:
                idx = (head[qi] + np.arange(ln[qi])) % depth
                freed.extend(int(x) for x in buf[qi, idx])
                ln[qi] = 0
            return ln

        qlen = clear(st["qbuf"].cpu().numpy(), st["qhead"].cpu().numpy(),
                     st["qlen"].cpu().numpy().copy(), self.Q, dead_in_q)
        oq_len = clear(st["oq_buf"].cpu().numpy(),
                       st["oq_head"].cpu().numpy(),
                       st["oq_len"].cpu().numpy().copy(),
                       self.cfg.out_queue, dead_out_q)
        if freed:
            head, ln = int(st["fl_head"]), int(st["fl_len"])
            pos = (head + ln + np.arange(len(freed))) % self.pool
            st["fl_buf"][torch.as_tensor(pos, device=dev)] = torch.as_tensor(
                freed, dtype=_I32, device=dev)
            st["fl_len"] = st["fl_len"] + len(freed)
            st["fail_drop"] = st["fail_drop"] + len(freed)
        st["qlen"] = torch.as_tensor(qlen, device=dev)
        st["oq_len"] = torch.as_tensor(oq_len, device=dev)
        return st

    def run_resilience(self, traffic: Traffic, warm: int = 200,
                       measure: int = 400, seed: int = 0) -> dict:
        """Throughput and latency under the attached failure schedule.

        Steps to each transition's slot boundary and applies it there
        (``tables.apply_failures`` -> :meth:`update_tables`, then
        :meth:`drop_dead_packets` under the ``drop`` policy); the
        transitions at the warm boundary apply before the window's
        snapshot.  The host syncs only at transitions and at the end.
        Whatever happens, the pristine tables are restored on return (the
        rebuild is deterministic, so the restore is exact), so a cached
        simulator stays reusable.  (The reference steps in chunks of a
        fixed length to bound its compile set; the port's slots are the
        same steps however they are grouped, so it steps straight to
        each boundary.)
        """
        if not self.has_failures:
            raise ValueError(
                "run_resilience needs a Simulator built with a non-empty "
                "FailureSchedule (failures=...); use run_throughput for "
                "pristine fabrics")
        sched = self.failures
        drop = sched.policy == "drop"
        trans = sched.transitions()
        st = self.make_state(traffic, seed)
        now, ti = 0, 0
        active: list = []

        def advance_to(target):
            nonlocal now
            if target > now:
                self.run_chunk(st, traffic, target - now)
                now = target

        def apply_due(boundary):
            nonlocal ti
            while ti < len(trans) and trans[ti][0] <= boundary:
                slot, downs, ups = trans[ti]
                advance_to(slot)
                self.update_tables(st, self.tables.apply_failures(
                    down=downs, up=ups))
                active.extend(downs)
                for ev in ups:
                    if ev in active:
                        active.remove(ev)
                if drop and downs:
                    self.drop_dead_packets(st)
                ti += 1

        keys = ("ejected", "hop_sum", "pool_stall", "fail_drop")
        try:
            apply_due(warm)
            advance_to(warm)
            base = torch.stack([st[k] for k in keys])
            hist0 = st["lat_hist"].clone()
            apply_due(warm + measure)
            advance_to(warm + measure)
            ej, hop, stall, fdrop = (int(x) for x in (
                torch.stack([st[k] for k in keys]) - base).cpu().numpy())
            total = int(st["ejected"])
            hist = (st["lat_hist"] - hist0).cpu().numpy()
        finally:
            if active or ti:
                # exact pristine restore, so the shared tables are clean
                # for the next caller
                self.tables.apply_failures(up=tuple(active))
        return {
            "throughput": ej / (self.S * measure),
            "avg_hops": hop / max(ej, 1),
            "ejected": total,
            "pool_stall": stall,
            "fail_drop": fdrop,
            "hist": hist,
            **percentiles(hist, LATENCY_QS),
            "state": st,
        }

    # ------------------------------------------------------------------ #
    # compiled workload programs (repro_torch.workloads)
    # ------------------------------------------------------------------ #
    @staticmethod
    def program_traffic(program) -> Traffic:
        """The :class:`Traffic` of a compiled program: only its phase
        count and schedule (the arrays ride in the state)."""
        return Traffic("program", n_phases=program.n_phases,
                       schedule=program.schedule, window=program.window)

    def make_program_state(self, program, seed: int = 0) -> dict:
        """A fresh state for a compiled program: ``make_state``'s, plus
        copies of the program's arrays on this simulator's device and the
        scheduler's registers (the ``phase`` counter, each phase's
        ``phase_done`` slot and ``phase_ok`` flag, and ``key0``, the key
        every barrier phase starts from)."""
        if program.n_endpoints != self.S:
            raise ValueError(
                f"program compiled for {program.n_endpoints} endpoints, "
                f"fabric has {self.S}")
        dev, n = self.device, program.n_phases
        st = self.make_state(self.program_traffic(program), seed)
        for k in PROG_SHARED:
            st[k] = getattr(program, k[len("prog_"):]).to(dev, _I32,
                                                          copy=True)
        st["phase"] = torch.zeros((), dtype=_I32, device=dev)
        st["phase_done"] = torch.full((n,), -1, dtype=_I32, device=dev)
        st["phase_ok"] = torch.zeros((n,), dtype=torch.bool, device=dev)
        st["key0"] = st["key"].clone()
        return st

    def make_program_batch_state(self, program, seeds) -> dict:
        """``make_program_state`` of each seed stacked on a leading
        replica axis, but the program's arrays (``PROG_SHARED``), the
        same for every replica, kept as one unstacked copy."""
        states = [self.make_program_state(program, int(s)) for s in seeds]
        if not states:
            raise ValueError("a batched state needs at least one seed")
        return {k: states[0][k] if k in PROG_SHARED
                else torch.stack([s[k] for s in states])
                for k in states[0]}

    def run_program(self, program, *, chunk: int = 16,
                    max_slots: int = 60_000, seed: int = 0, seeds=None,
                    state: Optional[dict] = None,
                    budget_chunks: Optional[int] = None) -> dict:
        """Run a compiled :class:`repro_torch.workloads.CompiledProgram`
        to its end.

        One of ``seed`` (a scalar run), ``seeds`` (a fresh batched run,
        ``make_program_batch_state``) or ``state`` (a scalar or batched
        program state, consumed).  Whether to run the next chunk of
        ``chunk`` slots is tested before each chunk, and only there (one
        host sync per chunk): ``barrier`` runs until every phase of every
        replica has crossed (a phase stuck past ``max_slots`` is forced
        across on a chunk boundary), ``window`` until every replica's
        last phase completes or the largest slot reaches ``max_slots``.
        A replica that finishes first steps on with its finished state
        until the others do.  Returns ``slots`` (total), ``completed``,
        ``pool_stall``, ``phase_slots`` (``[..., n_phases]``: per-phase
        durations under ``barrier``, cumulative completion slots under
        ``window``, where a phase never completed reports the final
        slot) and ``state``; per-replica arrays when batched.

        ``budget_chunks=B`` bounds one call to at most ``B`` chunks, the
        resumable runtime's segment: the result then also carries
        ``running`` (whether the next chunk would run; the other fields
        are partial until it is False), and a chain of bounded segments
        over the same state is bitwise one unbounded call.
        """
        assert max_slots < (1 << 23), \
            "max_slots overflows the p_bh born-slot packing (< 2^23)"
        traffic = self.program_traffic(program)
        if state is not None:
            st = state
        elif seeds is not None:
            st = self.make_program_batch_state(program, seeds)
        else:
            st = self.make_program_state(program, seed)
        b, scalar = self._batched(st)
        NP = traffic.n_phases
        window = traffic.schedule == "window"

        def running():
            if window:
                live = ((b["phase_done"][:, -1] < 0).any()
                        & (b["slot"].max() < max_slots))
            else:
                live = (b["phase"] < NP).any()
            return bool(live.item())

        chunks = 0
        while ((budget_chunks is None or chunks < budget_chunks)
               and running()):
            for _ in range(chunk):
                self._step(b, traffic, chunk=chunk, max_slots=max_slots)
            chunks += 1
        extra = {} if budget_chunks is None else {"running": running()}
        out = torch.cat([b["phase_done"], b["phase_ok"].to(_I32),
                         b["slot"][:, None], b["pool_stall"][:, None]],
                        dim=1).cpu().numpy()
        if scalar:
            _unbatch(st, b)
        done, ok = out[:, :NP], out[:, NP:2 * NP] > 0
        final, stall = out[:, -2], out[:, -1]
        if window:
            done = np.where(done >= 0, done, final[:, None]).astype(np.int32)
            slots = done[:, -1]
        else:
            slots = done.sum(axis=-1)
        completed = ok.all(axis=-1)
        if scalar:
            return {"slots": int(slots[0]), "completed": bool(completed[0]),
                    "pool_stall": int(stall[0]), "phase_slots": done[0],
                    "state": st, **extra}
        return {"slots": slots, "completed": completed, "pool_stall": stall,
                "phase_slots": done, "state": st, **extra}


def _unbatch(st: dict, b: dict) -> None:
    """Write the entries of ``b``, the one-replica view of the scalar
    state ``st`` (``Simulator._batched``), back into ``st``."""
    for k, v in b.items():
        st[k] = v if k in PROG_SHARED else v.squeeze(0)


def percentiles(hist: np.ndarray, qs) -> dict:
    """Latency percentiles from a histogram whose bin index *is* the latency
    in slots.  Uniformly ``float``: ``float(bin)``, or NaN for an empty
    histogram."""
    total = hist.sum()
    if total == 0:
        return {f"p{q}": float("nan") for q in qs}
    cum = np.cumsum(hist)
    return {f"p{q}": float(np.searchsorted(cum, q * total)) for q in qs}
