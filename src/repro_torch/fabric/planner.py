"""Fabric planner: the paper's contribution applied to a training system.

The port's ``repro.fabric.planner``, host arithmetic over the port's
``core.analytics``.  On a multi-pod system the ``pod`` mesh axis
crosses the datacenter (DCN) fabric — exactly the extreme-scale
leaf-spine network the paper studies.  The planner:

1. models candidate DCN fabrics with the paper's machinery
   (``repro_torch.core.analytics``): MRLS at a chosen thickness f,
   Fat-Tree, Dragonfly;
2. takes the *measured* cross-pod collective byte volumes from a dry-run
   record (the reference's ``repro.launch.dryrun`` JSON, as a dict);
3. estimates per-step cross-pod communication time on each fabric from the
   capacity limit Θ (Eq. 1) and per-pattern efficiency factors calibrated
   with the packet simulator (All2All-class traffic: MRLS ≈ 1.5x FT
   throughput at 100K endpoints, ≈ 2x DF — Section 6);
4. recommends the pod-axis strategy (plain DP sync vs EF-int8 compressed
   sync) and reports the fabric ranking.

This is deliberately a *model*, not a simulation of every step: the
simulator calibrates pattern efficiencies once (the committed
``benchmarks/CALIB_pattern_eff.json``, read as data), the planner applies
them to arbitrary byte volumes (the same separation the paper draws
between Θ and simulated L).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Mapping, Optional, Union

from ..core import analytics

# pattern efficiency = achieved fraction of min(1, Θ) under the pattern.
# DEFAULT_PATTERN_EFF is the hand-estimated fallback (benchmarks/fig5/6/7;
# the paper's figures); the *live* table below it is recalibrated
# from the committed design-space-search artifact
# (benchmarks/CALIB_pattern_eff.json, produced by
# scripts/calibrate_planner.py from artifacts/PARETO_search.json) —
# families/patterns the search did not measure keep the fallback value.
# all2all ~ uniform; allreduce (ring/halving over nearby ranks) is
# locality-friendly, which favors FT.
DEFAULT_PATTERN_EFF = {
    "mrls": {"all2all": 0.85, "allreduce": 0.75, "uniform": 0.85},
    "fat_tree": {"all2all": 0.60, "allreduce": 0.90, "uniform": 0.90},
    "dragonfly": {"all2all": 0.45, "allreduce": 0.75, "uniform": 0.75},
}

CALIB_PATH = Path(__file__).resolve().parents[3] / "benchmarks" \
    / "CALIB_pattern_eff.json"

# workload patterns (the workload registry's names) -> planner traffic class
_PATTERN_CLASS = {"uniform": "uniform", "all2all": "all2all",
                  "allreduce": "allreduce"}


def pattern_eff_from_search(records: Union[Mapping, list]) -> dict:
    """Distill ``eff[family][pattern]`` from search artifact record(s).

    ``records`` is a ``PARETO_search.json`` document: one search record,
    ``{"searches": [...]}``, or a list of records.  For every fully
    evaluated candidate, the achieved efficiency is measured throughput
    over the analytic ceiling ``min(1, Θ)``; per (family, pattern) the
    *best* candidate wins — the planner models the fabric one would
    actually deploy, not the average draw.
    """
    if isinstance(records, Mapping):
        records = records.get("searches", [records])
    eff: dict = {}
    for rec in records:
        pattern = _PATTERN_CLASS.get(
            rec.get("spec", {}).get("workload", {}).get("pattern"))
        if pattern is None:
            continue
        for cand in rec.get("candidates", ()):
            if cand.get("status") != "full":
                continue
            ceiling = min(1.0, cand["theta"])
            if ceiling <= 0:
                continue
            e = min(1.0, cand["throughput"] / ceiling)
            fam = eff.setdefault(cand["family"], {})
            fam[pattern] = max(fam.get(pattern, 0.0), e)
    return eff


def load_pattern_eff(path: Union[None, str, Path] = None) -> dict:
    """The live efficiency table: defaults overlaid with the committed
    calibration artifact (missing/unreadable file -> pure defaults)."""
    path = CALIB_PATH if path is None else Path(path)
    table = {fam: dict(pats) for fam, pats in DEFAULT_PATTERN_EFF.items()}
    try:
        with open(path) as f:
            calib = json.load(f)
    except (OSError, ValueError):
        return table
    for fam, pats in calib.get("eff", {}).items():
        for pattern, e in pats.items():
            table.setdefault(fam, {})[pattern] = float(e)
    return table


PATTERN_EFF = load_pattern_eff()


@dataclasses.dataclass
class FabricSpec:
    name: str               # mrls | fat_tree | dragonfly
    theta: float            # capacity limit (Eq. 1)
    cost_links: float       # links per endpoint (Eq. 2)
    link_gbps: float = 400.0


def build_fabric(kind: str, n_endpoints: int, radix: int = 64,
                 f: float = 2.0, link_gbps: float = 400.0) -> FabricSpec:
    """Instantiate a fabric model at ``n_endpoints`` NICs (pods x hosts)."""
    if kind == "mrls":
        n1, n2, u, d = analytics.mrls_design(n_endpoints, radix, f)
        A = analytics.mrls_expected_A(n1, n2, u, radix)
        theta = analytics.theta(u * n1, n1 * d, A)
        return FabricSpec("mrls", theta, u / d, link_gbps)
    if kind == "fat_tree":
        # non-blocking FT sized for n_endpoints (h levels as needed)
        k = radix // 2
        h = max(1, math.ceil(math.log(n_endpoints / (2 * k), k)))
        return FabricSpec("fat_tree", 1.0, float(h), link_gbps)
    if kind == "dragonfly":
        return FabricSpec("dragonfly", 1.0, 1.5, link_gbps)
    raise ValueError(kind)


def collective_time_s(fabric: FabricSpec, pattern: str,
                      bytes_per_endpoint: float) -> float:
    """Time to move ``bytes_per_endpoint`` under ``pattern``.

    endpoint injection rate = link_gbps; the fabric sustains
    eff * min(1, Θ) of it under the pattern.
    """
    eff = PATTERN_EFF[fabric.name][pattern]
    rate = fabric.link_gbps * 1e9 / 8 * eff * min(1.0, fabric.theta)
    return bytes_per_endpoint / rate


@dataclasses.dataclass
class PodAxisPlan:
    fabric_ranking: list          # [(name, step_comm_s, cost_links)]
    recommended_fabric: str
    compress_gradients: bool
    est_comm_s: dict


def plan_pod_axis(dryrun_record: dict, n_pod_endpoints: int = 512,
                  compute_s: Optional[float] = None,
                  link_gbps: float = 400.0) -> PodAxisPlan:
    """Given a dry-run JSON record, rank fabrics for its cross-pod traffic.

    Cross-pod traffic classes: the all-to-all bytes (MoE expert parallel)
    follow the All2All pattern; all-reduce/reduce-scatter bytes (DP/FSDP
    sync) follow the Allreduce pattern.
    """
    coll = dryrun_record["per_device"]["collective_bytes"]
    a2a = coll.get("all-to-all", 0.0)
    ar = (coll.get("all-reduce", 0.0) + coll.get("reduce-scatter", 0.0)
          + coll.get("all-gather", 0.0))
    ranking = []
    est = {}
    for kind in ("mrls", "fat_tree", "dragonfly"):
        fab = build_fabric(kind, n_pod_endpoints, link_gbps=link_gbps)
        t = (collective_time_s(fab, "all2all", a2a)
             + collective_time_s(fab, "allreduce", ar))
        ranking.append((kind, t, fab.cost_links))
        est[kind] = t
    ranking.sort(key=lambda x: x[1])
    best = ranking[0][0]
    # compress when cross-pod comm would not hide behind compute
    compress = compute_s is not None and est[best] > 0.5 * compute_s
    return PodAxisPlan(ranking, best, compress, est)
