"""Training driver: config registry, synthetic data pipeline, AdamW and
the fault-tolerant runner with checkpoints.

The port of the reference's ``launch/train.py``.  Parameters are drawn
by ``models.common.init_params`` (numpy, seed 0) on the run's device,
the card unless the caller asks for the CPU.  The step is
``launch.steps.make_train_step``: the forward through the hand-written
``flash_attention`` kernel on the card, the backward through autograd
(``kernels.flash_attention.backward``), then AdamW.

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 20 --seq 64 --global-batch 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

from .._device import resolve_device
from ..checkpointing.checkpoint import Checkpointer
from ..configs import get_config, reduced as reduce_cfg
from ..data.pipeline import DataConfig, SyntheticLM
from ..models.common import init_params
from ..models.model import build_specs
from ..optim.adamw import AdamWConfig, init_opt, warmup_cosine
from ..runtime.fault_tolerance import FaultTolerantRunner, FTConfig
from . import steps as ST

__all__ = ["build_training", "main"]


def build_training(cfg, opt: AdamWConfig, ckpt_dir: str, data: SyntheticLM,
                   ft: FTConfig = FTConfig(), fault_hook=None, device=None,
                   params=None):
    """``((params, opt_state), runner, ckpt)``: the initial state, a
    ``FaultTolerantRunner`` of the training step over ``data.batch_at``
    that checkpoints into ``ckpt_dir`` and restores onto ``device``
    (default: the card), and its ``Checkpointer``.  ``params`` are the
    initial parameters (default: ``init_params`` of the config's specs,
    seed 0, on ``device``)."""
    dev = resolve_device(device)
    specs = build_specs(cfg)
    if params is None:
        params = init_params(specs, 0, dev)
    opt_state = init_opt(specs, opt, dev)
    raw_step = ST.make_train_step(cfg, opt)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = raw_step(params, opt_state, batch)
        return (params, opt_state), metrics

    ckpt = Checkpointer(ckpt_dir)
    runner = FaultTolerantRunner(step_fn, data.batch_at, ckpt, ft,
                                 fault_hook=fault_hook, device=dev)
    return (params, opt_state), runner, ckpt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    opt = AdamWConfig(lr=args.lr,
                      schedule=warmup_cosine(args.steps // 10, args.steps))
    data = SyntheticLM(DataConfig(cfg.vocab, args.seq, args.global_batch),
                       device=dev)
    state, runner, ckpt = build_training(cfg, opt, args.ckpt_dir, data,
                                         device=dev)
    t0 = time.time()
    state, step, history = runner.run(state, 0, args.steps)
    print(json.dumps({
        "arch": cfg.name, "steps": step,
        "first_loss": history[0]["loss"], "last_loss": history[-1]["loss"],
        "wall_s": round(time.time() - t0, 1),
        "stragglers": len(runner.stragglers.flagged),
        "restarts": runner.restarts,
    }))


if __name__ == "__main__":
    main()
