"""The test mesh: one device behind the reference's three model axes.

The port of ``make_test_mesh`` from the reference's ``launch/mesh.py``.
Its ``make_production_mesh`` lowers a model onto 512 placeholder TPUs for
the dry run and comes with ``launch/dryrun`` (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from .._device import resolve_device
from ..parallel.sharding import Mesh

__all__ = ["make_test_mesh"]


def make_test_mesh(shape=(1, 1, 1), axes=("pod", "data", "model"),
                   device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose every position is
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    return Mesh((dev,) * n, tuple(axes), tuple(shape))
