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

Policies: ``polarized``, ``minimal_adaptive``, ``ksp``, and the
Dragonfly's ``ugal`` (UGAL-L: a Valiant intermediate leaf when the
queue-times-distance estimate says so) and ``valiant`` (always an
intermediate leaf).  Traffic: the Bernoulli families ``uniform``,
``rep``, ``rsp``, ``bu``, ``mice_elephant`` and the adversarial
``tornado``, ``shift``, ``hotspot`` and ``bursty`` (measured by
``run_throughput``/``run_latency``) and ``all2all`` (a finite program,
measured by ``run_completion``).  No failure schedule.

State and its lifetime:

* The state is a dict of tensors on the simulator's device, with the
  reference's keys and dtypes.  The PRNG key is an int32 ``[2]`` tensor
  holding the reference's two uint32 words (see :mod:`repro_torch.prng`).
* The pool-indexed tensors (``POOL_KEYS``) carry one pad slot at index
  ``pool``: the reference's ``mode="drop"`` scatters aim non-writers at
  index ``pool``; here they land in the pad slot, with no host sync.
  :func:`repro_torch.convert.state_to_numpy` strips it.
* ``run_chunk`` and the step functions update the state **in place**:
  they write into its tensors and rebind its entries, and return the
  same dict.  A state passed to them is consumed, as a donated state is
  in the reference; clone what you need to keep first.
* The step makes no host synchronisation: no ``.item()``, no
  ``nonzero``, no boolean-mask indexing.  ``run_completion`` syncs once
  per chunk, to test whether to run the next one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import prng
from .._device import resolve_device
from ..core.routing import RoutingTables
from ..kernels.switch_arb.ops import (flat_rows_geometry,
                                      switch_arbitrate_rows, vc_prearb)
from ..workloads.patterns import check_engine_pattern

__all__ = ["SimConfig", "Traffic", "Simulator", "pack_mask_block",
           "percentiles", "POLICIES", "POOL_KEYS", "LATENCY_QS"]

POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant")
_LATER_POLICIES = ("degraded",)
# the policies that route through an intermediate leaf (p_mid)
_VALIANT_POLICIES = ("ugal", "valiant")

# percentile ladder of the latency runs: median, p99, p999, p9999
LATENCY_QS = (0.5, 0.99, 0.999, 0.9999)

# state tensors indexed by packet id; each has a pad slot at index pool
POOL_KEYS = {"fl_buf": 0, "p_sd": 0, "p_mid": -1, "p_bh": 0}

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
    * ``all2all``: each endpoint sends ``rounds`` single-packet messages
      to ``(e + r + 1) mod S``, free-running (no round synchronization).
    """
    pattern: str = "uniform"
    load: float = 1.0
    rounds: int = 0
    elephant_frac: float = 0.1   # fraction of messages that are elephants
    elephant_size: int = 16
    # adversarial Bernoulli knobs
    shift: int = 1               # shift: dst = (e + shift) mod S
    hot_frac: float = 0.1        # hotspot: fraction of incast messages
    hot_count: int = 1           # hotspot: number of hot endpoints
    burst_len: float = 8.0       # bursty: mean ON duration (slots)
    burst_load: float = 1.0      # bursty: injection probability while ON

    def __post_init__(self):
        check_engine_pattern(self.pattern)


class Simulator:
    """The switch model on one device.

    ``device=None`` means the card; with no card it raises (pass
    ``device="cpu"`` to run the plain versions of the kernels).
    """

    def __init__(self, tables: RoutingTables, cfg: SimConfig, *,
                 device=None):
        if cfg.policy in _LATER_POLICIES:
            raise NotImplementedError(
                f"policy {cfg.policy!r} is not ported yet: it comes with the "
                "failure schedules")
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; expected one "
                             f"of {POLICIES + _LATER_POLICIES}")
        self.device = resolve_device(device)
        self._pt = cfg.threefry_partitionable
        topo = tables.topo
        self.tables, self.cfg = tables, cfg
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
        # int16 distances, flat [N1 * N]; polarized's hop budget reads them
        self.dist = torch.as_tensor(tables.dist_leaf, dtype=torch.int16,
                                    device=dev).reshape(-1)
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
        blocks of ``tables.leaf_block`` rows.  Only Polarized keeps the
        away bits."""
        n, n1, w = self.N, self.n1, self.W
        need_away = self.cfg.policy == "polarized"
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
        }

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

    def make_state(self, traffic: Traffic, seed: int = 0) -> dict:
        """A fresh state; a non-zero ``seed`` is folded into the key of
        ``cfg.seed`` (seed 0 keeps the plain key), as in the reference.
        ``rep`` adds its endpoint permutation ``perm`` and ``rsp`` its leaf
        permutation ``sigma``, drawn by numpy from ``seed`` as the
        reference draws them; ``bursty`` adds each endpoint's on-off
        state ``burst`` (all off)."""
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
        if seed:
            st["key"] = prng.fold_in(st["key"], seed)
        return st

    # ------------------------------------------------------------------ #
    def _port_bits(self, table, t_lr, cur):
        """[len(t_lr), P] bool port mask: one word gather per requester
        and a bit test (exact on the int32 views of the uint32 words)."""
        words = table[t_lr * self.N + cur]                       # [., W]
        return ((words[:, self._w_idx] >> self._b_idx) & 1).bool()

    @staticmethod
    def _mean_msg(t: Traffic) -> float:
        if t.pattern == "mice_elephant":
            return ((1 - t.elephant_frac) * 1.0
                    + t.elephant_frac * t.elephant_size)
        return 1.0

    def _inject(self, st, key, traffic: Traffic):
        """Start messages + push one packet per eligible endpoint."""
        S, d, pool, pt = self.S, self.d_leaf, self.pool, self._pt
        e = self._e
        k1, k2, k3, k4 = prng.split(key, 4, partitionable=pt)

        idle = st["msg_rem"] == 0
        pat = traffic.pattern
        size = 1
        burst_new = None
        if pat == "all2all":
            start = idle & (st["prog"] < traffic.rounds)
            dst = (e + st["prog"] + 1) % S
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
                ka, kb = prng.split(k3, 2, partitionable=pt)
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
                dst = st["sigma"][e // d] * d + e % d
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
                kh, ki = prng.split(k3, 2, partitionable=pt)
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
        rank = torch.cumsum(want_net.to(_I32), 0, dtype=_I32) - 1
        ok = want_net & (rank < st["fl_len"])
        slot_idx = (st["fl_head"] + rank.clamp(min=0)) % pool
        pid = torch.where(ok, st["fl_buf"][slot_idx], -1)
        n_pop = ok.sum(dtype=_I32)

        # non-injectors write into the pad slot at index pool
        widx = torch.where(ok, pid.clamp(min=0), pool)
        if burst_new is not None:
            st["burst"] = burst_new
        st["fl_head"] = (st["fl_head"] + n_pop) % pool
        st["fl_len"] = st["fl_len"] - n_pop
        st["p_sd"].index_put_((widx,), (src_lr << 16) | dst_lr)
        if self.cfg.policy in _VALIANT_POLICIES:
            st["p_mid"].index_put_((widx,), self._intermediate(
                st, k4, src_lr, dst_lr))
        st["p_bh"].index_put_((widx,), (st["slot"] << 8).expand(S))
        # push into the NIC queue (dense one-hot write, one row each)
        pos = (st["eq_head"] + st["eq_len"]) % self.QE
        slot_hot = ok[:, None] & (self._qe_ids[None, :] == pos[:, None])
        st["eq_buf"] = torch.where(slot_hot, pid.clamp(min=0)[:, None],
                                   st["eq_buf"])
        st["eq_len"] = st["eq_len"] + ok.to(_I32)

        consumed = ok | deliver_local
        st["msg_rem"] = msg_rem - consumed.to(_I32)
        st["msg_dst"] = msg_dst
        st["prog"] = prog
        n_local = deliver_local.sum(dtype=_I32)
        st["created"] = st["created"] + ok.sum(dtype=_I32) + n_local
        st["ejected"] = st["ejected"] + n_local
        st["pool_stall"] = st["pool_stall"] + (want_net & ~ok).sum(
            dtype=_I32)
        st["lat_hist"][1] += n_local
        return st

    def _intermediate(self, st, key, src_lr, dst_lr):
        """Each endpoint's intermediate leaf rank, -1 for none: a uniform
        leaf for ``valiant``; for ``ugal`` that leaf only where the
        shortest-queue estimate times the hop count via it is smaller
        (strictly) than the minimal route's, from the occupancies of VC 0
        at the source switch."""
        N = self.N
        mid_lr = prng.randint(key, (self.S,), 0, self.n1,
                              partitionable=self._pt)
        if self.cfg.policy == "valiant":
            return mid_lr
        sw = self.leaf_ids[src_lr]
        occ0 = st["qlen"][self._ugal_occ_idx]                      # [S, P]

        def best(t_lr):
            m = self._port_bits(self.min_mask, t_lr, sw)
            return torch.where(m, occ0, 1 << 20).amin(dim=1)
        q_min, q_val = best(dst_lr), best(mid_lr)
        # int16 distances and their int16 sum; the products promote to
        # int32, as in the reference
        d_min = self.dist[dst_lr * N + sw]
        d_val = (self.dist[mid_lr * N + sw]
                 + self.dist[dst_lr * N + self.leaf_ids[mid_lr]])
        take_val = q_min * d_min > q_val * d_val
        return torch.where(take_val, mid_lr, -1)

    # ------------------------------------------------------------------ #
    def _crossbar_round(self, st, key):
        """One crossbar sub-round: VC pre-arbitration, routing, output
        arbitration, input-queue -> output-queue moves, ejections."""
        N, P, V, Q, S = self.N, self.P, self.V, self.Q, self.S
        OQ, NP, pool = self.cfg.out_queue, self.N * self.P, self.pool
        k_vc, k_tie, k_arb = prng.split(key, 3, partitionable=self._pt)

        # ---- VC pre-arbitration: one candidate VC per (switch, in-port)
        # and that queue's head packet (-1: no candidate) ----
        vc_rand = prng.uniform(k_vc, (N, P, V), partitionable=self._pt)
        vc_sel, _has, net_pkt = vc_prearb(st["qlen"].reshape(N, P, V),
                                          vc_rand, st["qbuf"], st["qhead"])
        vc_sel = vc_sel.reshape(-1)
        net_pkt = net_pkt.reshape(-1)

        # endpoint (NIC) heads
        ep_head = st["eq_buf"].reshape(-1)[self._e * self.QE + st["eq_head"]]
        ep_pkt = torch.where(st["eq_len"] > 0, ep_head, -1)

        # ---- unified requester table ----
        cur = self.cur                                             # [NR]
        pkt = torch.cat([net_pkt, ep_pkt])
        valid = pkt >= 0
        pkt0 = pkt.clamp(min=0)
        bh = st["p_bh"][pkt0]
        hops = bh & 0xFF
        sd = st["p_sd"][pkt0]
        t_lr = sd & 0xFFFF
        eject = valid & (cur == self.leaf_ids[t_lr])
        route = valid & ~eject
        pol = self.cfg.policy
        if pol == "polarized":
            # Forward = away-from-s & toward-t, Expansion = away & away
            # (while d_cs < d_ct), Contraction = toward & toward (once
            # d_cs >= d_ct); d(n,t) = d(c,t) + away - toward
            s_lr = sd >> 16
            dn_t = self._port_bits(self.min_mask, t_lr, cur)
            up_t = self._port_bits(self.away_mask, t_lr, cur)
            dn_s = self._port_bits(self.min_mask, s_lr, cur)
            up_s = self._port_bits(self.away_mask, s_lr, cur)
            d_ct = self.dist[t_lr * N + cur]
            d_cs = self.dist[s_lr * N + cur]
            src_side = (d_cs < d_ct)[:, None]
            deroute = (up_s & up_t & src_side) | (dn_s & dn_t & ~src_side)
            d_nt = (d_ct[:, None] + up_t.to(torch.int16)
                    - dn_t.to(torch.int16))
            budget_ok = (hops[:, None] + 1 + d_nt) <= self.cfg.max_hops
            allowed = (up_s & dn_t) | (deroute & budget_ok)
        elif pol in _VALIANT_POLICIES:
            # minimal toward the intermediate leaf while there is one
            mid_lr = st["p_mid"][pkt0]
            tgt = torch.where(mid_lr >= 0, mid_lr, t_lr)
            allowed = self._port_bits(self.min_mask, tgt, cur)
            deroute = torch.zeros_like(allowed)
        else:   # minimal_adaptive, ksp
            allowed = self._port_bits(self.min_mask, t_lr, cur)
            deroute = torch.zeros_like(allowed)
        # the flight VC climbs with every hop under ugal / valiant, with
        # every up-down pass (two hops) under the others
        vc_hops = hops if pol in _VALIANT_POLICIES else hops // 2
        next_vc = vc_hops.clamp(max=V - 1)
        tie = prng.uniform(k_tie, (self.NR, P), partitionable=self._pt)
        rnd = prng.randint(k_arb, (self.NR,), 0, 1 << 8,
                             partitionable=self._pt)
        # one kernel: congestion (local output queue + downstream input
        # queue for the flight VC), credit (room in the local output
        # queue), scores, first argmin and the segmented output
        # arbitration; ksp's random walk scores the tiebreak alone
        _port, win, seg = switch_arbitrate_rows(
            tie, allowed, deroute, route, rnd, next_vc, st["oq_len"],
            st["qlen"], nic_first=self._nic_first, dq_base=self._dq_base,
            d=self.d_leaf, penalty=float(self.cfg.deroute_penalty),
            out_queue=OQ, zero_occ=pol == "ksp")
        win = win > 0

        # ---- moves: input queue -> output queue ----
        # the winning priority word per output port is the inverted grant:
        # its low 23 bits are the unique flat requester index
        exist = seg >= 0                                           # [N*P]
        wlo = torch.where(exist, seg & ((1 << 23) - 1), 0)
        win_pkt = pkt0[wlo]                                        # [N*P]
        win_vc = next_vc[wlo]
        push = (exist[:, None] & (win_vc[:, None] == self._v_ids)).reshape(-1)
        pos = (st["oq_head"] + st["oq_len"]) % OQ                  # [NQ]
        slot_hot = push[:, None] & (self._oq_ids[None, :] == pos[:, None])
        win_pkt_q = win_pkt[:, None].expand(NP, V).reshape(-1)     # [NQ]
        st["oq_buf"] = torch.where(slot_hot, win_pkt_q[:, None],
                                   st["oq_buf"])
        st["oq_len"] = st["oq_len"] + push.to(_I32)

        # pops: winners + ejectors leave their input queues (each
        # (switch, in-port) pops at most its one pre-arbitrated VC)
        leave = win | eject
        pop = (leave[:NP, None] & (vc_sel[:, None] == self._v_ids)
               ).reshape(-1).to(_I32)                              # [NQ]
        st["qhead"] = (st["qhead"] + pop) % Q
        st["qlen"] = st["qlen"] - pop
        ep_leave = leave[NP:].to(_I32)
        st["eq_head"] = (st["eq_head"] + ep_leave) % self.QE
        st["eq_len"] = st["eq_len"] - ep_leave

        # ejections: free-list push (only network inputs eject) + stats
        ej_n = eject[:NP]
        erank = torch.cumsum(ej_n.to(_I32), 0, dtype=_I32) - 1
        fpos = (st["fl_head"] + st["fl_len"] + erank.clamp(min=0)) % pool
        st["fl_buf"].index_put_((torch.where(ej_n, fpos, pool),), pkt0[:NP])
        st["fl_len"] = st["fl_len"] + ej_n.sum(dtype=_I32)
        lat = (st["slot"] - (bh[:NP] >> 8) + 1).clamp(
            0, self.cfg.hist_bins - 1)
        st["lat_hist"].index_add_(0, torch.where(ej_n, lat, 0),
                                  ej_n.to(_I32))
        st["ejected"] = st["ejected"] + eject.sum(dtype=_I32)
        st["hop_sum"] = st["hop_sum"] + torch.where(eject, hops, 0).sum(
            dtype=_I32)
        return st

    def _link_phase(self, st, key):
        """Move one packet per link: output-queue head -> downstream input
        queue (credit-checked), incrementing the packet's hop count."""
        N, P, V, Q = self.N, self.P, self.V, self.Q
        OQ, NP = self.cfg.out_queue, self.N * self.P
        # one non-empty output VC per (switch, port) with downstream room,
        # by random priority: the masked argmax of VC pre-arbitration
        room = st["qlen"][self._link_dq] < Q                        # [N*P,V]
        nonempty = st["oq_len"].reshape(NP, V) > 0
        cand = nonempty & room & self._valid[:, None]
        rand = prng.uniform(key, (NP, V), partitionable=self._pt)
        # and the chosen queue's head packet; a non-sender's -1 clamps to
        # 0, which nothing reads (it adds 0 hops and is never pushed)
        vcs, send, head = vc_prearb(cand.to(_I32).reshape(N, P, V),
                                    rand.reshape(N, P, V), st["oq_buf"],
                                    st["oq_head"])
        vcs = vcs.reshape(-1)
        send = send.reshape(-1) > 0
        pkt0 = head.reshape(-1).clamp(min=0)

        # each (switch, port) pops at most one VC; each input port receives
        # from exactly one static upstream output port (link reversal)
        pop = (send[:, None] & (vcs[:, None] == self._v_ids)
               ).reshape(-1).to(_I32)                               # [NQ]
        st["oq_head"] = (st["oq_head"] + pop) % OQ
        st["oq_len"] = st["oq_len"] - pop
        recv = send[self._rev_idx] & self._valid                    # [N*P]
        recv_vc = vcs[self._rev_idx]
        recv_pkt = pkt0[self._rev_idx]
        push = (recv[:, None] & (recv_vc[:, None] == self._v_ids)).reshape(-1)
        qpos = (st["qhead"] + st["qlen"]) % Q                       # [NQ]
        slot_hot = push[:, None] & (self._q_ids[None, :] == qpos[:, None])
        recv_pkt_q = recv_pkt[:, None].expand(NP, V).reshape(-1)
        st["qbuf"] = torch.where(slot_hot, recv_pkt_q[:, None], st["qbuf"])
        st["qlen"] = st["qlen"] + push.to(_I32)
        # hop increment on the packed born|hops word (hops: low byte);
        # non-senders add 0
        st["p_bh"].index_add_(0, pkt0, send.to(_I32))
        if self.cfg.policy in _VALIANT_POLICIES:
            # a packet sent to its intermediate leaf's switch forgets it
            # (the others write the pad slot)
            mid_lr = st["p_mid"][pkt0]
            reached = send & (mid_lr >= 0) & (
                self._link_nb == self.leaf_ids[mid_lr.clamp(min=0)])
            st["p_mid"].index_fill_(
                0, torch.where(reached, pkt0, self.pool).long(), -1)
        return st

    def _step(self, st, traffic: Traffic):
        key, k_inj, k_link, *k_xb = prng.split(
            st["key"], 3 + self.cfg.speedup, partitionable=self._pt)
        st["key"] = key
        self._inject(st, k_inj, traffic)
        for r in range(self.cfg.speedup):
            self._crossbar_round(st, k_xb[r])
        self._link_phase(st, k_link)
        st["slot"] = st["slot"] + 1
        return st

    def run_chunk(self, st, traffic: Traffic, n_slots: int):
        """Advance ``n_slots`` slots in place; returns ``st``."""
        for _ in range(n_slots):
            self._step(st, traffic)
        return st

    # ------------------------------------------------------------------ #
    # measurement runs
    # ------------------------------------------------------------------ #
    def run_throughput(self, traffic: Traffic, warm: int = 200,
                       measure: int = 400, seed: int = 0) -> dict:
        st = self.make_state(traffic, seed)
        self.run_chunk(st, traffic, warm)
        base = {k: st[k].clone() for k in ("ejected", "hop_sum",
                                           "pool_stall")}
        self.run_chunk(st, traffic, measure)
        # the window deltas come back to the host in one transfer
        ej, hop, stall, total = torch.stack(
            [st[k] - base[k] for k in base] + [st["ejected"]]).cpu().tolist()
        return {
            "throughput": ej / (self.S * measure),
            "avg_hops": hop / max(ej, 1),
            "ejected": total,
            "pool_stall": stall,
            "state": st,
        }

    def run_completion(self, traffic: Traffic, expected: int,
                       chunk: int = 128, max_slots: int = 100_000,
                       seed: int = 0) -> dict:
        """Run until ``expected`` packets are delivered (collectives).

        ``slots`` is the exact slot at which the ejection counter first
        reached ``expected``: a ``done`` tensor on the device records it
        after every step, with no sync.  Whether to run the next chunk of
        ``chunk`` slots is tested before each chunk, and only there (one
        host sync per chunk), so the run ends on a chunk boundary and
        ``pool_stall`` and ``state`` are read there.  A run that reaches
        ``max_slots`` first reports the final slot and
        ``completed=False``.
        """
        # p_bh packs the born slot above the hop byte; past 2^23 slots the
        # shifted value would wrap int32 and corrupt latency measurement
        assert max_slots < (1 << 23), \
            "max_slots overflows the p_bh born-slot packing (< 2^23)"
        st = self.make_state(traffic, seed)
        done = torch.full((), -1, dtype=_I32, device=self.device)
        while bool(((done < 0) & (st["slot"] < max_slots)).item()):
            for _ in range(chunk):
                self._step(st, traffic)
                newly = (st["ejected"] >= expected) & (done < 0)
                done = torch.where(newly, st["slot"], done)
        done, final, stall = torch.stack(
            [done, st["slot"], st["pool_stall"]]).cpu().tolist()
        return {"slots": done if done >= 0 else final,
                "completed": done >= 0, "pool_stall": stall, "state": st}

    def run_latency(self, traffic: Traffic, warm: int = 200,
                    measure: int = 600, seed: int = 0) -> dict:
        st = self.make_state(traffic, seed)
        self.run_chunk(st, traffic, warm)
        base = st["lat_hist"].clone()
        self.run_chunk(st, traffic, measure)
        hist = (st["lat_hist"] - base).cpu().numpy()
        return {"hist": hist, **percentiles(hist, LATENCY_QS)}


def pack_mask_block(dist_block: torch.Tensor, valid: torch.Tensor,
                    nbr_safe: torch.Tensor, *, away: bool = True):
    """``(min, away)`` int32 words [B, N, W] for a block of int16 leaf
    distance rows ``dist_block`` [B, N]: the reference's
    ``core.routing._pack_mask_block`` on the device, as int32 views of
    its uint32 words (``away`` is None unless asked for).

    ``valid`` [N, P] bool marks the ports with a link, ``nbr_safe``
    [N, P] int64 is the neighbour with -1 mapped to 0.  Port ``j`` sets
    bit ``j % 32`` of word ``j // 32``; the words are built with
    ``bitwise_or`` on int32, where bit 31 is -2**31, so no sum ever
    wraps.  One port at a time keeps the temporaries at [B, N].
    """
    d = dist_block
    p = valid.shape[1]
    min_w = torch.zeros(d.shape + ((p + 31) // 32,), dtype=_I32,
                        device=d.device)
    away_w = torch.zeros_like(min_w) if away else None
    for j in range(p):
        dn = d[:, nbr_safe[:, j]]                               # [B, N]
        bit = np.uint32(1 << (j % 32)).view(np.int32).item()
        min_w[:, :, j // 32].bitwise_or_(
            (valid[:, j] & (dn == d - 1)).to(_I32) * bit)
        if away:
            away_w[:, :, j // 32].bitwise_or_(
                (valid[:, j] & (dn == d + 1)).to(_I32) * bit)
    return min_w, away_w


def percentiles(hist: np.ndarray, qs) -> dict:
    """Latency percentiles from a histogram whose bin index *is* the latency
    in slots.  Uniformly ``float``: ``float(bin)``, or NaN for an empty
    histogram."""
    total = hist.sum()
    if total == 0:
        return {f"p{q}": float("nan") for q in qs}
    cum = np.cumsum(hist)
    return {f"p{q}": float(np.searchsorted(cum, q * total)) for q in qs}
