"""Mesh construction: the production mesh and the one-device test mesh.

The port of the reference's ``launch/mesh.py``.  Single pod: 16 x 16 =
256 ranks, axes ("data", "model").  Multi-pod: 2 x 16 x 16 = 512 ranks,
axes ("pod", "data", "model"); the "pod" axis crosses the fabric between
pods whose topology the paper optimizes, and ``repro_torch.fabric``'s
planner reads the dry run's cross-pod collective bytes to pick it.

Defined as functions (never module-level constants), so that importing
this module initializes no process group: the caller sets one up first
(``launch.dryrun`` sets up a fake one of 256 or 512 ranks in its own
process) and :func:`make_production_mesh` lays the mesh over its ranks.
"""
from __future__ import annotations

import math

import torch

from .._device import resolve_device
from ..parallel.sharding import Mesh

__all__ = ["make_production_mesh", "mesh_over_group", "make_test_mesh",
           "production_axes"]


def production_axes(multi_pod: bool = False) -> tuple:
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> tuple:
    """``(Mesh, DeviceMesh)`` of the production axes over the process
    group the caller has set up (:func:`mesh_over_group`).  Raises unless
    that group has exactly 256 (512 with ``multi_pod``) ranks; it never
    builds a smaller mesh in its place."""
    return mesh_over_group(*production_axes(multi_pod))


def mesh_over_group(shape, axes) -> tuple:
    """``(Mesh, DeviceMesh)``: the port's :class:`Mesh` of ``shape`` over
    ``axes`` and the ``DeviceMesh`` of the initialized process group laid
    out the same way.  The ``Mesh``'s positions are ``meta`` devices, and
    the ``DeviceMesh`` a host one: its tensors are meta shards, held by
    the group's ranks.  Raises unless a process group of exactly the
    mesh's size is initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"the mesh {dict(zip(axes, shape))} needs a process group of "
            f"{n} ranks; none is initialized (launch.dryrun sets up a fake "
            "one)")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"the mesh {dict(zip(axes, shape))} needs {n} ranks, the "
            f"process group has {dist.get_world_size()}")
    device_mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    mesh = Mesh((torch.device("meta"),) * n, axes, shape)
    return mesh, device_mesh


def make_test_mesh(shape=(1, 1, 1), axes=("pod", "data", "model"),
                   device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose every position is
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    return Mesh((dev,) * n, tuple(axes), tuple(shape))
