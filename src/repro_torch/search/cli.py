"""``python -m repro_torch.api search`` — the design-space search command.

The port's ``repro.search.cli``: a spec file holds one search object,
``{"search": {...}}`` or ``{"searches": [...]}``; ``--pareto-out`` writes
the frontier artifact (default ``artifacts/PARETO_search.json``), and
``--out`` the search records, as the reference's CLI does.
"""
from __future__ import annotations

import dataclasses
import json
import os

from .loop import search
from .spec import SearchSpec

__all__ = ["PARETO_OUT", "main_search", "write_pareto"]

PARETO_OUT = os.path.join("artifacts", "PARETO_search.json")


def write_pareto(records, path: str) -> None:
    """Write search record(s) as the frontier artifact."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    doc = records[0] if len(records) == 1 else {"searches": records}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def _summary(rec: dict) -> None:
    c = rec["counts"]
    print(f"{rec['name']}  strategy={rec['strategy']}  "
          f"objective={rec['objective']}  candidates={rec['n_candidates']}"
          f"/{rec['space_size']}  invalid={c['invalid']}  "
          f"pruned={c['pruned']}  screened={c['screened']}  "
          f"full={c['full']}")
    by_id = {r["id"]: r for r in rec["candidates"]}
    for cid in rec["frontier"]:
        r = by_id[cid]
        print(f"  * {r['label']:<40s} thr={r['throughput']:.3f}  "
              f"C_l={r['cost_links']:.3f}  obj={r['objective']:.3f}")


def main_search(args, spec_dicts) -> list:
    """Run the searches of ``spec_dicts`` under the CLI's ``--replicas``,
    ``--seed``, ``--pareto-out`` and ``--device``; returns the records."""
    specs = [SearchSpec.from_dict(d) for d in spec_dicts]
    if args.replicas is not None:
        specs = [dataclasses.replace(s, replicas=args.replicas)
                 for s in specs]
    if args.seed is not None:
        specs = [dataclasses.replace(s, seed=args.seed) for s in specs]
    records = [search(s, device=args.device) for s in specs]
    for rec in records:
        _summary(rec)
    if args.pareto_out:
        write_pareto(records, args.pareto_out)
        print(f"wrote Pareto artifact to {args.pareto_out}")
    return records
