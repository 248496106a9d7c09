"""Batched serving: prefill + greedy decode with a KV/SSM cache.

``ServeSession`` holds a model's parameters on a device; ``generate`` runs
greedy decoding for a batch of prompts with one shared position cursor
(fixed-width batches, the reference's simplification).  Prefill runs the
hand-written kernels on the card (``flash_attention`` and
``selective_scan`` in every layer); decode is plain PyTorch.  A model
with context tokens (a vision model's patch embeddings, an
encoder-decoder's audio frames) is served with its context, ``ctx``;
the CLI draws it as the reference's does, after the prompts from the
same generator.

    python -m repro_torch.launch.serve --arch hymba-1.5b --reduced \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config, reduced as reduce_cfg
from ..models.common import init_params
from ..models.model import build_specs, decode_step, prefill

__all__ = ["ServeSession", "greedy", "ctx_tensor", "main"]


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Argmax over the real vocabulary of the last position: [B,1] int64;
    ties go to the lowest index."""
    return logits[:, -1:, :vocab].argmax(-1)


class ServeSession:
    """A model ready to serve on ``device`` (default: the card).

    ``params`` is the port's parameter tree (``convert.params_from_jax``
    gives one from the reference's); without it the weights are drawn
    from ``seed`` by ``models.common.init_params``."""

    def __init__(self, cfg, params=None, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else init_params(
            build_specs(cfg), seed, self.device)

    @torch.inference_mode()
    def generate(self, prompts, max_new: int = 16, ctx=None) -> np.ndarray:
        """prompts: [B, S] int -> [B, max_new] int32 greedy tokens.

        ``ctx`` [B, Sc, d_model] is the context of a model with context
        tokens (vision tokens, audio frames), needed by such a model and
        refused by any other: a tensor, or an array whose values are
        rounded to bf16 (from float32, to nearest even)."""
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        if ctx is not None:
            ctx = ctx_tensor(ctx, self.device)
        logits, cache = prefill(self.params, tokens, self.cfg, ctx)
        pos = tokens.shape[1]
        tok = greedy(logits, self.cfg.vocab)
        out = [tok]
        for i in range(max_new - 1):
            logits, cache = decode_step(self.params, cache, tok, pos + i,
                                        self.cfg)
            tok = greedy(logits, self.cfg.vocab)
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def ctx_tensor(ctx, device) -> torch.Tensor:
    """A context as a bf16 tensor on ``device``: a tensor is moved and
    cast, an array goes through float32 (a float64 array is rounded to
    float32 first, then to bf16)."""
    if not isinstance(ctx, torch.Tensor):
        ctx = torch.from_numpy(np.ascontiguousarray(ctx, np.float32))
    return ctx.to(device=device, dtype=torch.bfloat16)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    ctx = None
    if cfg.n_ctx_tokens:            # the stub frontend's embeddings
        ctx = rng.normal(size=(args.batch, cfg.n_ctx_tokens, cfg.d_model))
    sess = ServeSession(cfg, device=args.device)
    t0 = time.time()
    toks = sess.generate(prompts, args.max_new, ctx)
    print(json.dumps({"arch": cfg.name, "generated": toks.shape,
                      "wall_s": round(time.time() - t0, 1),
                      "sample": toks[0][:8].tolist()}, default=str))


if __name__ == "__main__":
    main()
