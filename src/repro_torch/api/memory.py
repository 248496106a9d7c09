"""Spec-level memory estimate of an experiment: the reference's price.

``estimate_memory(network, route, replicas=R)`` is the reference's
``repro.api.estimate_memory``, copied as it is: it prices the JAX
engine's layout (routing tables, the dense or blocked mask layout the
reference would pick, per-replica state, engine constants and the
step's transient upper bound) from the spec and the host topology
alone, and returns the reference's dict field for field.  The design
search's records (``est_total_bytes``, ``est_peak_bytes``) and its
``mem_budget_mib`` pruning read it, so a search record of the port
equals the reference's.

It is not the port's footprint.  The port keeps one mask layout, builds
its tables on the card by min-plus squaring of an ``[N, N]`` int16
adjacency and holds its tensors in PyTorch's caching allocator; its own
byte model is :func:`repro_torch.api.admission.device_peak_bytes`, which
the admission gate prices experiments with.
"""
from __future__ import annotations

from typing import Union

from ..core import routing as _routing
from ..core.routing import mask_table_bytes
from .registry import network_topology
from .specs import Experiment, NetworkSpec, RouteSpec

__all__ = ["estimate_memory", "format_bytes"]


def format_bytes(n: Union[int, float]) -> str:
    """Human-readable bytes (binary units)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"  # pragma: no cover - loop always returns


def estimate_memory(network: Union[NetworkSpec, Experiment],
                    route: RouteSpec = RouteSpec(), *,
                    replicas: int = 1) -> dict:
    """Byte-level memory estimate for a fabric + routing configuration.

    ``network`` is a :class:`NetworkSpec` (with ``route``/``replicas``
    given explicitly) or a whole :class:`Experiment` (its route and
    replica count are used).  Returns a dict with exact dims, a
    per-category byte breakdown, and ``total_bytes`` — the expected
    resident footprint of one live simulator plus ``replicas`` stacked
    states; ``peak_bytes`` adds the step-transient upper bound.
    """
    if isinstance(network, Experiment):
        route = network.route
        replicas = network.replicas
        network = network.network
    topo = network_topology(network)

    n = topo.n_switches
    p = topo.max_ports
    n1 = topo.n_leaves
    s = topo.n_endpoints
    d = topo.endpoints_per_leaf
    v, q, oq, qe = route.vcs, route.queue_depth, route.out_queue, \
        route.endpoint_queue
    nq = n * p * v
    w = (p + 31) // 32
    nr = n * p + s
    r_max = p + d
    # the engine's pool default (SimConfig.pool or auto)
    pool = route.pool or int(min(2_000_000, max(1 << 14, s * 6)))

    # ---- routing tables (device-resident) ---------------------------- #
    one_mask = mask_table_bytes(n1, n, p)
    n_masks = 2 if route.policy in ("polarized", "degraded") else 1
    dist_bytes = n1 * n * 2                           # int16
    # read the limit off the module so it tracks build_tables' "auto"
    # resolution exactly (including test-time overrides)
    mask_layout = ("dense" if one_mask <= _routing.DENSE_MASK_LIMIT
                   else "blocked")
    # dense layout also retains the numpy twins on the host (both masks,
    # regardless of policy); blocked streams them and retains nothing
    host_mask_bytes = 2 * one_mask if mask_layout == "dense" else 0
    tables = {
        "dist_leaf_bytes": dist_bytes,
        "device_mask_bytes": n_masks * one_mask,
        "host_mask_bytes": host_mask_bytes,
        "mask_layout": mask_layout,
    }

    # ---- engine constants (per simulator, replica-invariant) --------- #
    constants = (
        4 * n * p * 4          # nbrs, nbr_port, nbrs0, valid_port(word-ish)
        + n * v * p * 4        # _dq_perm
        + nr * 4 * 2           # cur, _row_of
        + n * r_max * 5        # _dense_src (int32) + _dense_valid (bool)
        + n * p * 4            # _rev_idx
        + (s * p * 4 if route.policy == "ugal" else 0)   # _ugal_occ_idx
    )

    # ---- mutable state (per replica) --------------------------------- #
    state = (
        nq * q * 4 + nq * 8            # qbuf + qhead/qlen
        + nq * oq * 4 + nq * 8         # oq_buf + oq_head/oq_len
        + s * qe * 4 + s * 8           # eq_buf + eq_head/eq_len
        + pool * 4 * 4                 # fl_buf, p_sd, p_mid, p_bh
        + s * 4 * 3                    # msg_rem, msg_dst, prog
        + route.hist_bins * 4          # lat_hist
    )

    # ---- failure-schedule state (per replica, armed schedules only) --- #
    # with a non-empty FailureSchedule the engine moves the routing
    # tables INTO the state (tbl_min[/tbl_away] + tbl_dist) so
    # update_tables can rewrite them without recompiling, and adds the
    # live up-masks (link_up [N*P] bool, switch_up [N] bool) plus the
    # fail_drop counter
    has_failures = (network.failures is not None
                    and len(network.failures) > 0)
    failure_state = (n_masks * one_mask + dist_bytes   # tbl_min/away/dist
                     + n * p + n                       # link_up, switch_up
                     + 4) if has_failures else 0       # fail_drop
    state += failure_state

    # ---- step transients (jit-internal upper bound) ------------------ #
    # dominated by the [NR, P] f32 score/tie/occ planes (a handful are
    # live at once) and the [N, R_max, P] one-hot of the segmented
    # arbitration max
    transient = 6 * nr * p * 4 + n * r_max * p
    if has_failures:
        # host-side delta rebuild scratch: _pack_mask_block packs
        # affected leaf rows in leaf_block chunks (min+away words live
        # at once while repacking)
        transient += 2 * min(256, n1) * n * w * 4

    total = (tables["dist_leaf_bytes"] + tables["device_mask_bytes"]
             + tables["host_mask_bytes"] + constants + replicas * state)
    return {
        "network": network.to_dict(),
        "policy": route.policy,
        "replicas": replicas,
        "dims": {"n_switches": n, "n_leaves": n1, "n_endpoints": s,
                 "max_ports": p, "mask_words": w, "pool": pool,
                 "n_queues": nq, "n_requesters": nr},
        "tables": tables,
        "failures": {"armed": has_failures,
                     "state_bytes_per_replica": failure_state},
        "constants_bytes": constants,
        "state_bytes_per_replica": state,
        "transient_bytes": transient,
        "total_bytes": total,
        "peak_bytes": total + replicas * transient,
    }
