"""``python -m repro_torch.api <command>`` — the port's CLI.

Commands (each takes ``--device cpu|cuda``; the default is the card):

* ``run <spec.json> [--out f]`` — run an experiment spec (the
  reference's JSON format) and print its Result as JSON; ``--out`` also
  writes it to a file.  A file of ``{"experiments": [...]}`` runs them
  all through one ``run_all`` (a simulator shared by the experiments of
  a fabric) and prints the list of records.
* ``sweep <spec.json> [--seed S] [--out f]`` — the spec file holds
  ``{"base": <experiment>, "axes": {"workload.load": [...], ...}}``;
  prints one summary line per grid point, ``--out`` writes the Results
  as a JSON list.  ``--seed`` overrides the base seed.
* ``families`` — list the topology families the port builds.
* ``patterns`` — list the workload-pattern registry, each with its kind
  and whether the port runs it (every collective does, the arrival
  families not yet).

``families`` and ``patterns`` run nothing; they take ``--device`` so
that every command has the same surface.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .registry import topology_families, workload_patterns
from .runner import Result, run, run_all
from .specs import Experiment
from .sweep import sweep


def _summary(res: Result) -> str:
    """One line a Result: its name, metric and the populated fields."""
    bits = [res.name, f"metric={res.metric}"]
    if res.throughput is not None:
        bits.append(f"throughput={res.throughput:.3f}")
        bits.append(f"avg_hops={res.avg_hops:.2f}")
    if res.latency is not None:
        bits.append("lat " + "/".join(f"{k}={v}"
                                      for k, v in res.latency.items()))
    if res.slots is not None:
        bits.append(f"slots={res.slots}")
        bits.append(f"completed={res.completed}")
    return "  ".join(bits)


def _cmd_run(args) -> int:
    doc = json.loads(Path(args.spec).read_text())
    if isinstance(doc, dict) and "experiments" in doc:
        exps = [Experiment.from_dict(d) for d in doc["experiments"]]
        text = json.dumps([r.to_dict() for r in run_all(
            exps, device=args.device)], indent=1)
    else:
        text = run(Experiment.from_dict(doc),
                   device=args.device).to_json(indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


def _cmd_sweep(args) -> int:
    doc = json.loads(Path(args.spec).read_text())
    base = Experiment.from_dict(doc["base"])
    if args.seed is not None:
        base = base.override("seed", args.seed)
    results = sweep(base, doc.get("axes", {}), device=args.device)
    for res in results:
        print(_summary(res))
    if args.out:
        Path(args.out).write_text(json.dumps(
            [r.to_dict() for r in results], indent=2) + "\n")
        print(f"wrote {len(results)} result(s) to {args.out}")
    return 0


def _cmd_families(_args) -> int:
    for name in topology_families():
        print(name)
    return 0


def _cmd_patterns(_args) -> int:
    for name, kind, ported in workload_patterns():
        print(f"{name}  [{kind}]" + ("" if ported else "  (not ported yet)"))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="run one experiment spec")
    sweep_p = sub.add_parser("sweep", help="run a {base, axes} sweep spec")
    sweep_p.add_argument("--seed", type=int, default=None,
                         help="override the base experiment's seed")
    for p in (run_p, sweep_p):
        p.add_argument("spec", help="spec JSON file")
        p.add_argument("--out", default=None,
                       help="also write the Result(s) here")
    sub.add_parser("families", help="list topology families")
    sub.add_parser("patterns", help="list workload patterns")
    for p in sub.choices.values():
        p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                       help="default: cuda (fails without a card)")
    args = ap.parse_args(argv)
    return {"run": _cmd_run, "sweep": _cmd_sweep, "families": _cmd_families,
            "patterns": _cmd_patterns}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
