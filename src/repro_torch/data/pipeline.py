"""Deterministic synthetic LM data pipeline with a prefetch thread.

The port of the reference's ``data/pipeline.py``.  The stream is a
counter-based hash (splitmix64) in numpy, bit for bit the reference's:
reproducible anywhere, no filesystem, and restart-safe, since a batch is
a pure function of its step, so a restored job replays exactly the
batches it would have seen (``runtime.fault_tolerance``).  ``batch_at``
returns int32 tensors on the pipeline's device (the card unless the
caller asks for the CPU), where the reference places them with its
sharder.

A background thread prefetches ``prefetch`` batches ahead of the
consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["DataConfig", "SyntheticLM"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    prefetch: int = 2
    markov_order: bool = True   # learnable structure (not pure noise)


class SyntheticLM:
    """Counter-based token stream; ``batch_at(step)`` is pure.  Batches
    go onto ``device`` (default: the card)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch_np(self, step: int) -> dict:
        """The batch of ``step`` as int32 numpy arrays ``{"tokens",
        "labels"}`` [global_batch, seq]: the reference's bits."""
        c = self.cfg
        idx = (np.uint64(step) * np.uint64(c.global_batch * (c.seq + 1))
               + np.arange(c.global_batch * (c.seq + 1), dtype=np.uint64)
               + np.uint64(c.seed) * np.uint64(0x2545F4914F6CDD1D))
        h = _splitmix64(idx).reshape(c.global_batch, c.seq + 1)
        toks = (h % np.uint64(c.vocab)).astype(np.int32)
        if c.markov_order:
            # overwrite odd positions with a deterministic function of the
            # previous token -> the LM has something to learn
            prev = toks[:, :-1]
            succ = ((prev.astype(np.int64) * 31 + 7) % c.vocab
                    ).astype(np.int32)
            toks[:, 1::2] = succ[:, ::2][:, : toks[:, 1::2].shape[1]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch_at(self, step: int) -> dict:
        """The batch of ``step`` as int32 tensors on the pipeline's
        device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.batch_np(step).items()}

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        """Prefetching iterator starting at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(s), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
