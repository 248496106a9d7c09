"""``python -m repro_torch.api <command>`` — the port's CLI.

Commands (each takes ``--device cpu|cuda``; the default is the card):

* ``run <spec.json> [--replicas R] [--seed S] [--out f]`` — run an
  experiment spec (the reference's JSON format) and print its Result as
  JSON; ``--out`` also writes it to a file.  A file of
  ``{"experiments": [...]}`` runs them all through one ``run_all`` (a
  simulator shared by the experiments of a fabric, consecutive
  seed-only experiments folded into one batched run) and prints the
  list of records.  ``--replicas R`` overrides every experiment's
  ``replicas`` (R seeds from ``seed`` as one batched run: the record
  carries ``per_replica``, ``aggregates`` and ``replica_seeds``);
  ``--seed`` every experiment's seed.  ``--ckpt-dir D`` runs a
  single-experiment spec resumably (``run_resumable``): the engine's
  state is snapshotted into ``D`` every ``--ckpt-every`` chunks
  (``completion``) or slots (the windowed metrics; default 64), and the
  same command after a kill resumes from the latest snapshot, bitwise.
* ``resume <ckpt_dir> [--ckpt-every N] [--out f]`` — continue (or just
  report) the run stored in a ``--ckpt-dir`` directory from its spec and
  latest snapshot; a finished run prints its stored Result.
* ``sweep <spec.json> [--replicas R] [--seed S] [--out f]`` — the spec
  file holds ``{"base": <experiment>, "axes": {"workload.load": [...],
  ...}}``; prints one summary line per grid point, ``--out`` writes the
  Results as a JSON list.  ``--replicas`` and ``--seed`` override the
  base's.
* ``serve-sweep <spec.json> [--seed S] [--out f]`` — run open-loop
  serving SLO sweeps: the file holds one ServingSpec, ``{"serving":
  {...}}`` or ``{"servings": [...]}`` (the reference's format); prints
  each sweep's points, saturation knee and request leg, ``--out`` writes
  the SLO records as a JSON list, as the reference's CLI does.
  ``--seed`` overrides every spec's seed.
* ``degrade <spec.json> [--seed S] [--out f]`` — run link-failure
  degradation sweeps: the file holds one DegradeSpec (``{"base":
  <experiment>, "rates": [...], ...}``), ``{"sweep": {...}}`` or
  ``{"sweeps": [...]}``; prints delivered throughput and retention per
  rate, ``--out`` writes the degradation records as a JSON list, as the
  reference's CLI does.  ``--seed`` overrides every base's seed.
* ``families`` — list the topology families the port builds.
* ``patterns`` — list the workload-pattern registry, each with its kind
  and whether the port runs it.

``families`` and ``patterns`` run nothing; they take ``--device`` so
that every command has the same surface.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import List, Optional

from .registry import topology_families, workload_patterns
from .resume import resume, run_resumable
from .runner import Result, run, run_all
from .degrade import DegradeSpec, degrade_sweep_many
from .specs import Experiment
from .sweep import sweep
from .. import serving


def load_spec(path: str):
    """``(experiment dicts, whether the file is a list of them)``: a
    ``{"experiments": [...]}`` file, an ``{"experiment": {...}}`` wrapper
    or a bare experiment object."""
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, dict) and "experiments" in doc:
        return list(doc["experiments"]), True
    if isinstance(doc, dict) and "experiment" in doc:
        return [doc["experiment"]], False
    return [doc], False


def spec_experiments(path: str, *, replicas: Optional[int] = None,
                     seed: Optional[int] = None) -> List[Experiment]:
    """The experiments of a spec file with the shared ``--replicas`` /
    ``--seed`` overrides applied, as the reference's CLI applies them."""
    exps = [Experiment.from_dict(d) for d in load_spec(path)[0]]
    if replicas is not None:
        exps = [e.override("replicas", replicas) for e in exps]
    if seed is not None:
        exps = [e.override("seed", seed) for e in exps]
    return exps


def _summary(res: Result) -> str:
    """One line a Result: its name, metric and the populated fields."""
    bits = [res.name, f"metric={res.metric}"]
    if res.replica_seeds is not None:
        bits.append(f"replicas={len(res.replica_seeds)}")
    if res.offered is not None:
        bits.append(f"offered={res.offered:.3f}")
        bits.append(f"delivered={res.throughput:.3f}")
        if res.dropped:
            bits.append(f"dropped={res.dropped:g}")
    elif res.throughput is not None:
        bits.append(f"throughput={res.throughput:.3f}")
        bits.append(f"avg_hops={res.avg_hops:.2f}")
    if res.latency is not None:
        bits.append("lat " + "/".join(f"{k}={v}"
                                      for k, v in res.latency.items()))
    if res.slots is not None:
        bits.append(f"slots={res.slots}")
        bits.append(f"completed={res.completed}")
    return "  ".join(bits)


def _emit(text: str, out: Optional[str]) -> None:
    print(text)
    if out:
        Path(out).write_text(text + "\n")


def _cmd_run(args) -> int:
    exps = spec_experiments(args.spec, replicas=args.replicas,
                            seed=args.seed)
    listed = load_spec(args.spec)[1]
    if args.ckpt_dir is not None:
        if len(exps) != 1:
            print("--ckpt-dir needs a single-experiment spec "
                  f"(got {len(exps)})", file=sys.stderr)
            return 2
        results = [run_resumable(exps[0], args.ckpt_dir,
                                 every=args.ckpt_every, device=args.device)]
    elif listed:
        results = run_all(exps, device=args.device)
    else:
        results = [run(exps[0], device=args.device)]
    _emit(json.dumps([r.to_dict() for r in results], indent=1) if listed
          else results[0].to_json(indent=1), args.out)
    return 0


def _cmd_resume(args) -> int:
    res = resume(args.ckpt_dir, every=args.ckpt_every, device=args.device)
    _emit(res.to_json(indent=1), args.out)
    return 0


def _cmd_sweep(args) -> int:
    doc = json.loads(Path(args.spec).read_text())
    base = Experiment.from_dict(doc["base"])
    if args.replicas is not None:
        base = base.override("replicas", args.replicas)
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


def _fmt_q(v) -> str:
    return "-" if v is None else f"{v:g}"


def spec_docs(path: str, key: str) -> list:
    """The spec dicts of a file: a bare spec, ``{key: {...}}`` or
    ``{key + "s": [...]}``, as the reference's CLI reads them."""
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, dict) and key + "s" in doc:
        return list(doc[key + "s"])
    if isinstance(doc, dict) and key in doc:
        return [doc[key]]
    return [doc]


def _cmd_serve_sweep(args) -> int:
    specs = [serving.ServingSpec.from_dict(d)
             for d in spec_docs(args.spec, "serving")]
    if args.seed is not None:
        specs = [s.replace(seed=args.seed) for s in specs]
    records = serving.serve_sweep_many(specs, device=args.device)
    for rec in records:
        print(f"{rec['name']}  process={rec['spec']['process']}  "
              f"loads={len(rec['points'])}")
        for p in rec["points"]:
            print(f"  load={p['load']:g}  offered={p['offered']:.3f}  "
                  f"delivered={p['delivered']:.3f}  "
                  f"p50={_fmt_q(p.get('p50'))}  p99={_fmt_q(p.get('p99'))}  "
                  f"p999={_fmt_q(p.get('p999'))}  dropped={p['dropped']:g}")
        sat = rec["saturation"]
        print("  saturation: " + (
            f"load={sat['load']:g} (delivered/offered={sat['ratio']:.3f})"
            if sat else "none within swept loads"))
        req = rec.get("request")
        if req:
            print(f"  request: {req['model']}/{req['phase']} -> "
                  f"{req['pattern']} ranks={req['shape']['ranks']} "
                  f"packets={req['shape']['packets']} "
                  f"slots={req['slots']} completed={req['completed']}")
    if args.out:
        Path(args.out).write_text(json.dumps(records, indent=2))
        print(f"wrote {len(records)} SLO record(s) to {args.out}")
    return 0


def _cmd_degrade(args) -> int:
    specs = [DegradeSpec.from_dict(d) for d in spec_docs(args.spec, "sweep")]
    if args.seed is not None:
        specs = [dataclasses.replace(
            s, base=s.base.override("seed", args.seed)) for s in specs]
    records = degrade_sweep_many(specs, device=args.device)
    for rec in records:
        print(f"{rec['name']}  policy={rec['policy']}  "
              f"fail_policy={rec['fail_policy']}  links={rec['n_links']}")
        for p in rec["points"]:
            ret = ("-" if p["retention"] is None
                   else f"{p['retention']:.3f}")
            print(f"  rate={p['rate']:g}  down={p['n_links_down']}  "
                  f"delivered={p['delivered']:.3f}  retention={ret}  "
                  f"p50={_fmt_q(p.get('p50'))}  p99={_fmt_q(p.get('p99'))}  "
                  f"fail_drop={p['fail_drop']:g}")
    if args.out:
        Path(args.out).write_text(json.dumps(records, indent=2))
        print(f"wrote {len(records)} degradation record(s) to {args.out}")
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
    for p in (run_p, sweep_p):
        p.add_argument("spec", help="spec JSON file")
        p.add_argument("--replicas", type=int, default=None,
                       help="override the replicas (seeds run as one "
                            "batched run)")
        p.add_argument("--seed", type=int, default=None,
                       help="override the seed")
        p.add_argument("--out", default=None,
                       help="also write the Result(s) here")
    run_p.add_argument("--ckpt-dir", default=None,
                       help="checkpoint directory: run resumably, "
                            "snapshotting the engine's state at segment "
                            "boundaries (single-experiment specs only)")
    run_p.add_argument("--ckpt-every", type=int, default=64,
                       help="segment length between checkpoints, in engine "
                            "chunks (completion) or slots (windowed "
                            "metrics); default 64")
    resume_p = sub.add_parser(
        "resume", help="resume a --ckpt-dir run from its latest snapshot")
    resume_p.add_argument("ckpt_dir", help="checkpoint directory of the run")
    resume_p.add_argument("--ckpt-every", type=int, default=64,
                          help="segment length for the continued run")
    resume_p.add_argument("--out", default=None,
                          help="also write the Result here")
    serve_p = sub.add_parser("serve-sweep",
                             help="run open-loop serving SLO sweep spec(s)")
    serve_p.add_argument("spec", help="path to the ServingSpec JSON file")
    serve_p.add_argument("--seed", type=int, default=None,
                         help="override the seed")
    serve_p.add_argument("--out", default=None,
                         help="also write the SLO records here")
    degrade_p = sub.add_parser(
        "degrade", help="run a link-failure degradation sweep spec")
    degrade_p.add_argument("spec", help="path to the DegradeSpec JSON file")
    degrade_p.add_argument("--seed", type=int, default=None,
                           help="override the spec's base seed")
    degrade_p.add_argument("--out", default=None,
                           help="also write the degradation records here")
    sub.add_parser("families", help="list topology families")
    sub.add_parser("patterns", help="list workload patterns")
    for p in sub.choices.values():
        p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                       help="default: cuda (fails without a card)")
    args = ap.parse_args(argv)
    return {"run": _cmd_run, "resume": _cmd_resume, "sweep": _cmd_sweep,
            "serve-sweep": _cmd_serve_sweep, "degrade": _cmd_degrade,
            "families": _cmd_families,
            "patterns": _cmd_patterns}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
