"""The work of a hand kernel's launch on ``meta`` tensors, for an
accountant of a traced step (``launch.op_stats``).

A kernel launched through ctypes is no PyTorch operation, so a dispatch
mode does not see it.  On ``meta`` tensors (a dry run: shapes, no data)
each kernel's op returns empty outputs and calls :func:`record` with the
operations and bytes that one launch of the kernel does at those shapes
(the counts its bench divides by the card's rates for the bound), and
every listener that :func:`listening` has installed gets them.
"""
from __future__ import annotations

import contextlib

__all__ = ["record", "listening"]

_LISTENERS: list = []


def record(name: str, flops: float, n_bytes: float) -> None:
    """One launch of kernel ``name``: ``flops`` operations, ``n_bytes``
    bytes read and written."""
    for fn in _LISTENERS:
        fn(name, flops, n_bytes)


@contextlib.contextmanager
def listening(fn):
    """``fn(name, flops, n_bytes)`` is called for every :func:`record`
    inside the block."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)
