"""``python -m repro_torch.api run <spec.json> [--device cpu|cuda] [--out f]``

Runs one experiment spec (the reference's JSON format) and prints its
Result as JSON; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .runner import run
from .specs import Experiment


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="run one experiment spec")
    p.add_argument("spec", help="experiment spec JSON file")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="default: cuda (fails without a card)")
    p.add_argument("--out", default=None, help="also write the Result here")
    args = ap.parse_args(argv)
    exp = Experiment.from_dict(json.loads(Path(args.spec).read_text()))
    text = run(exp, device=args.device).to_json(indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
