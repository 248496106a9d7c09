"""Load-latency SLO sweeps over open-loop serving traffic.

:func:`serve_sweep` expands a
:class:`repro_torch.serving.spec.ServingSpec` into one ``serving``-metric
experiment per offered load, runs them through
:func:`repro_torch.api.run_all` on one shared simulator (one fabric, one
set-up), on the card by default (``device="cpu"`` on request), and
folds the results into the reference's SLO record::

    {"name": ..., "spec": {...},
     "points": [{"load", "offered", "delivered", "p50", "p99", "p999",
                 "p9999", "dropped", "pool_stall"}, ...],
     "saturation": {"load", "offered", "delivered", "ratio"} | None,
     "request": {...} | None}

The saturation knee is the first swept load whose delivered throughput
falls below ``sat_ratio * offered`` — the point where the open loop
stops keeping up and latency curves go vertical.  When the spec names an
LM request, ``request`` holds the bridged collective's completion record
(slots to finish one request's traffic on an idle fabric).
"""
from __future__ import annotations

from typing import Optional

from ..api.runner import SimulatorCache, run_all
from ..api.specs import Experiment, WorkloadSpec
from .spec import ServingSpec

__all__ = ["serve_sweep", "serve_sweep_many"]


def _experiments(spec: ServingSpec) -> list:
    wl_kw = dict(pareto_alpha=spec.pareto_alpha, pareto_cap=spec.pareto_cap,
                 diurnal_amp=spec.diurnal_amp,
                 diurnal_period=spec.diurnal_period, arr_depth=spec.arr_depth)
    return [
        Experiment(network=spec.network, route=spec.route,
                   workload=WorkloadSpec(spec.process, load=load, **wl_kw),
                   name=f"{spec.label()}@{load:g}", seed=spec.seed,
                   replicas=spec.replicas, warm=spec.warm,
                   measure=spec.measure, max_slots=spec.max_slots)
        for load in spec.loads
    ]


def _point(load: float, res) -> dict:
    return {"load": load, "offered": res.offered,
            "delivered": res.throughput, "dropped": res.dropped,
            "pool_stall": res.pool_stall, **(res.latency or {})}


def _saturation(points, sat_ratio: float) -> Optional[dict]:
    for p in points:
        if p["offered"] and p["delivered"] < sat_ratio * p["offered"]:
            return {"load": p["load"], "offered": p["offered"],
                    "delivered": p["delivered"],
                    "ratio": p["delivered"] / p["offered"]}
    return None


def _request_record(spec: ServingSpec, cache: Optional[SimulatorCache],
                    device) -> Optional[dict]:
    if not spec.model:
        return None
    from ..api.registry import build_network
    from .bridge import request_phase_shape, request_to_spec
    from ..configs import get_config

    S = int(build_network(spec.network).n_endpoints)
    cfg = get_config(spec.model)
    wl = request_to_spec(cfg, spec.phase, S, ranks=spec.ranks,
                         tokens=spec.tokens, batch=spec.batch)
    shape = request_phase_shape(cfg, spec.phase, ranks=wl.ranks,
                                tokens=spec.tokens, batch=spec.batch)
    exp = Experiment(network=spec.network, route=spec.route, workload=wl,
                     name=f"{spec.label()}/request", seed=spec.seed,
                     warm=0, measure=0, max_slots=spec.max_slots)
    res = run_all([exp], cache=cache, device=device)[0]
    return {"model": cfg.name, "phase": spec.phase, "shape": shape,
            "pattern": wl.pattern, "slots": res.slots,
            "completed": res.completed, "avg_hops": res.avg_hops}


def serve_sweep(spec: ServingSpec, *,
                cache: Optional[SimulatorCache] = None,
                device=None) -> dict:
    """Run one serving sweep and return its SLO record (see module doc).
    ``device=None`` runs on the card and raises without one."""
    own = cache is None
    if own:
        cache = SimulatorCache()
    try:
        results = run_all(_experiments(spec), cache=cache, device=device)
        points = [_point(load, res)
                  for load, res in zip(spec.loads, results)]
        record = {
            "name": spec.label(),
            "spec": spec.to_dict(),
            "points": points,
            "saturation": _saturation(points, spec.sat_ratio),
            "request": _request_record(spec, cache, device),
        }
    finally:
        if own:
            cache.close()
    return record


def serve_sweep_many(specs, *, cache: Optional[SimulatorCache] = None,
                     device=None) -> list:
    """Sweep several specs (e.g. MRLS vs Fat-Tree at matched endpoint
    count) sharing one simulator cache; returns one record per spec."""
    own = cache is None
    if own:
        cache = SimulatorCache()
    try:
        return [serve_sweep(s, cache=cache, device=device) for s in specs]
    finally:
        if own:
            cache.close()
