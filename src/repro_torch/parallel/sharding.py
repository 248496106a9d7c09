"""Logical-axis sharding: maps logical axis names to the axes of a mesh.

The port of the reference's ``parallel/sharding.py``.  Logical axes:

* ``fsdp``   — parameter sharding over the data (and pod) axes;
* ``tp``     — tensor parallel over the ``model`` axis;
* ``dp``     — activation batch sharding over (pod, data);
* ``sp``     — sequence sharding;
* ``None``   — replicated.

The simulator resolves through its own profile
(:meth:`ShardingRules.for_sim_mesh` / :func:`make_sim_mesh`):

* ``replica`` — the replica axis of ``make_batch_state``; the replicas
  are independent, so ``Simulator.run_chunk_sharded`` splits them over
  the mesh's devices, bitwise the single-device run;
* ``switch``  — the queue-major (switch-indexed) state dimension
  (``Simulator.state_shardings`` / ``shard_state``).

A :class:`Mesh` here is named axes over a tuple of ``torch.device``s,
and, unlike a JAX mesh, a device may repeat in it: the shards that a
repeated device holds run one after another on it.  So the split and
the merge run on one card, or on the CPU, as they would over distinct
cards.  :meth:`Sharder.sharding` gives a :class:`Placement` (the mesh
and the resolved axis of each dim) where the reference gives a
``NamedSharding``; :meth:`Placement.place` moves a tensor whole to the
one device its split axes span, and refuses a split over distinct
devices (:data:`SPLIT_REFUSAL`).

A model laid out over ranks is partitioned by DTensor
(``torch.distributed.tensor``), which plays GSPMD's part: a
:class:`Sharder` built with a ``DeviceMesh`` (``device_mesh=``, the
mesh's axes as its dim names) places tensors as DTensors
(:meth:`Placement.dtensor_placements`), and :meth:`Sharder.constrain` /
:meth:`Sharder.constrain_safe`, the reference's
``with_sharding_constraint``, redistribute a DTensor to the resolved
placements; on a plain tensor they are the identity.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch

from .._device import canonical_device

__all__ = ["Mesh", "Placement", "Sharder", "ShardingRules", "make_sim_mesh",
           "place_tree", "is_dtensor", "as_dtensor", "reduce_partial",
           "SPLIT_REFUSAL"]

# what a split over distinct devices needs, and where the ROADMAP lists it
SPLIT_REFUSAL = ("the port does not split a simulator state or a tensor "
                 "placed by Placement.place over distinct devices: the "
                 "switch-partitioned step needs its packet exchange in "
                 "_link_phase written with DTensor and the functional "
                 "collectives, which it does not have yet (ROADMAP queue 1 "
                 "item 16)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over ``devices`` (row-major over ``axis_names``, whose
    sizes are ``axis_sizes``; one axis over all of them by default).  A
    device may repeat; ``"cuda"`` is stored as the current card's
    index."""
    devices: tuple
    axis_names: tuple
    axis_sizes: Optional[tuple] = None

    def __post_init__(self):
        devices = tuple(canonical_device(d) for d in self.devices)
        names = tuple(self.axis_names)
        sizes = (tuple(int(s) for s in self.axis_sizes)
                 if self.axis_sizes is not None else (len(devices),))
        if len(names) != len(sizes):
            raise ValueError(f"{len(names)} axis names for {len(sizes)} "
                             "axis sizes")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        if math.prod(sizes) != len(devices) or not devices:
            raise ValueError(f"axes {dict(zip(names, sizes))} need "
                             f"{math.prod(sizes)} devices, got "
                             f"{len(devices)}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def device_at(self, coords: Sequence[int]) -> torch.device:
        """The device at one index of every axis."""
        flat = 0
        for c, n in zip(coords, self.axis_sizes):
            flat = flat * n + c
        return self.devices[flat]

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis``, every other axis at index 0: the
        device of each shard of a dim split over ``axis``."""
        i = self.axis_names.index(axis)
        return tuple(self.device_at([c if j == i else 0
                                     for j in range(len(self.axis_sizes))])
                     for c in range(self.axis_sizes[i]))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor goes: the mesh and, per dim, the resolved mesh axis
    (a name, a tuple of names, or None: not split)."""
    mesh: Mesh
    spec: tuple

    def split_axes(self) -> tuple:
        out = []
        for ax in self.spec:
            if ax is not None:
                out += list(ax) if isinstance(ax, tuple) else [ax]
        return tuple(out)

    def devices(self) -> tuple:
        """The distinct devices that would hold a part of the tensor: the
        mesh's devices over every index of the split axes, the other axes
        at index 0.  One device for a tensor that is not split (the
        mesh's first), or whose split axes all run over one device."""
        axes = self.split_axes()
        names, sizes = self.mesh.axis_names, self.mesh.axis_sizes
        ranges = [range(n) if a in axes else range(1)
                  for a, n in zip(names, sizes)]
        return tuple(dict.fromkeys(self.mesh.device_at(c)
                                   for c in itertools.product(*ranges)))

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` moved whole to the one device its split axes span;
        raises ``NotImplementedError`` for a split over distinct
        devices."""
        devs = self.devices()
        if len(devs) > 1:
            raise NotImplementedError(
                f"placement {self.spec} splits a tensor of shape "
                f"{tuple(t.shape)} over {len(devs)} devices "
                f"{[str(d) for d in devs]}; {SPLIT_REFUSAL}")
        return t.to(devs[0])

    def dtensor_placements(self) -> list:
        """The DTensor placements of this placement, one a mesh axis in
        the mesh's order: ``Shard(i)`` on an axis that splits dim ``i``,
        else ``Replicate()``.  A dim split over several axes is split in
        the mesh's order of them, as a JAX mesh splits it (major axis
        first); an axis of size 1 holds the whole tensor and is
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        owner = {}
        for i, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    owner[a] = i
        return [Shard(owner[a]) if a in owner and n > 1 else Replicate()
                for a, n in zip(self.mesh.axis_names, self.mesh.axis_sizes)]


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (False where torch has no
    ``torch.distributed``)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def as_dtensor(t, device_mesh):
    """``t`` as a DTensor on ``device_mesh``: a plain tensor is the same
    on every rank (a tensor the step makes itself), so it is replicated
    on every axis."""
    if is_dtensor(t) or t is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def reduce_partial(t):
    """A DTensor ``t`` with every partial sum reduced (``Partial`` to
    ``Replicate``: an all-reduce), its splits kept; a plain tensor as it
    is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def place_tree(tree, placements):
    """Each tensor leaf of ``tree`` placed by the :class:`Placement` at
    the same path of ``placements`` (nested dicts, lists and tuples of
    the same structure), as ``jax.tree.map(jax.device_put, tree,
    shardings)``; other leaves are kept as they are."""
    if isinstance(placements, dict):
        return {k: place_tree(tree[k], v) for k, v in placements.items()}
    if isinstance(placements, (list, tuple)):
        return type(placements)(place_tree(t, p)
                                for t, p in zip(tree, placements))
    return placements.place(tree) if isinstance(tree, torch.Tensor) \
        else tree


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical name -> mesh axis (or tuple of axes)."""
    fsdp: tuple = ("data",)
    dp: tuple = ("data",)
    tp: Optional[str] = "model"
    sp: Optional[str] = None        # sequence-parallel axis (perf option)
    replica: Optional[str] = None   # simulator replica-batch axis
    switch: Optional[str] = None    # simulator queue-major (switch) axis

    @staticmethod
    def for_mesh(mesh: Mesh, sequence_parallel: bool = False) \
            -> "ShardingRules":
        axes = mesh.axis_names
        data_axes = tuple(a for a in ("pod", "data") if a in axes)
        return ShardingRules(
            fsdp=data_axes,
            dp=data_axes,
            tp="model" if "model" in axes else None,
            sp="model" if sequence_parallel and "model" in axes else None,
        )

    @staticmethod
    def for_sim_mesh(mesh: Mesh) -> "ShardingRules":
        """The simulator profile: only the ``replica``/``switch`` axes
        resolve (the model-side names resolve to replicated)."""
        axes = mesh.axis_names
        return ShardingRules(
            fsdp=(), dp=(), tp=None, sp=None,
            replica="replica" if "replica" in axes else None,
            switch="switch" if "switch" in axes else None,
        )


def make_sim_mesh(n_devices: Optional[int] = None, axis: str = "replica",
                  device=None) -> Mesh:
    """A 1-D simulator mesh over ``axis`` (``"replica"`` | ``"switch"``).

    Without ``device``: over the first ``n_devices`` cards that
    ``torch.cuda.device_count()`` sees (default: all of them); more than
    there are raises, and so does a host with no card.  With ``device``
    (``"cpu"``, ``"cuda:0"``, ...): ``n_devices`` shards (default 1) on
    that one device, which run one after another."""
    if device is not None:
        return Mesh((torch.device(device),) * (n_devices or 1), (axis,))
    have = torch.cuda.device_count()
    if have == 0:
        raise RuntimeError(
            "no CUDA device is available: a simulator mesh spans the cards "
            "by default; pass device='cpu' to split over shards on the "
            "host")
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), (axis,))


class Sharder:
    """Resolves logical axis names against a concrete mesh; with
    ``device_mesh`` (a ``DeviceMesh`` of the same axes, as
    ``launch.mesh.make_production_mesh`` gives), it also places and
    constrains DTensors on that mesh's ranks."""

    def __init__(self, mesh: Mesh, rules: Optional[ShardingRules] = None,
                 device_mesh=None):
        self.mesh = mesh
        self.rules = rules or ShardingRules.for_mesh(mesh)
        if device_mesh is not None and (
                tuple(device_mesh.mesh_dim_names) != mesh.axis_names
                or tuple(device_mesh.shape) != mesh.axis_sizes):
            got = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))
            raise ValueError(f"device mesh {got} is not the mesh "
                             f"{mesh.shape}")
        self.device_mesh = device_mesh

    @classmethod
    def for_simulator(cls, mesh: Optional[Mesh] = None,
                      n_devices: Optional[int] = None,
                      axis: str = "replica", device=None) -> "Sharder":
        """The simulator profile: a :func:`make_sim_mesh` mesh (or a
        caller-built one) with :meth:`ShardingRules.for_sim_mesh` rules."""
        mesh = mesh if mesh is not None else make_sim_mesh(n_devices, axis,
                                                           device)
        return cls(mesh, ShardingRules.for_sim_mesh(mesh))

    def _resolve(self, name) -> Optional[object]:
        if name is None:
            return None
        if name == "fsdp":
            r = self.rules.fsdp
            return r if len(r) > 1 else (r[0] if r else None)
        if name == "dp":
            r = self.rules.dp
            return r if len(r) > 1 else (r[0] if r else None)
        if name == "tp":
            return self.rules.tp
        if name == "sp":
            return self.rules.sp
        if name == "replica":
            return self.rules.replica
        if name == "switch":
            return self.rules.switch
        raise ValueError(f"unknown logical axis {name!r}")

    def pspec(self, names: Sequence[Optional[str]]) -> tuple:
        """The resolved axis of each name: equal to the reference's
        ``PartitionSpec`` taken as a tuple."""
        return tuple(self._resolve(n) for n in names)

    def sharding(self, names: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Placement:
        """The :class:`Placement` of ``names``.  With ``shape``, a logical
        axis whose mesh size does not divide its dim is dropped
        (replicated), as the reference drops it (e.g. 8 KV heads on a
        16-way TP axis)."""
        if shape is None:
            return Placement(self.mesh, self.pspec(names))
        resolved = []
        for dim, n in zip(shape, names):
            ax = self._resolve(n)
            if ax is None:
                resolved.append(None)
                continue
            size = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                size *= self.mesh.shape[a]
            resolved.append(ax if dim % size == 0 else None)
        return Placement(self.mesh, tuple(resolved))

    def constrain(self, x, *names):
        """The reference's ``with_sharding_constraint`` by logical names:
        a DTensor redistributed to the resolved placements; a plain
        tensor as it is."""
        if not is_dtensor(x):
            return x
        return x.redistribute(x.device_mesh,
                              self.sharding(names).dtensor_placements())

    def constrain_safe(self, x, *names):
        """:meth:`constrain` with every axis that does not divide its dim
        dropped (replicated), as the reference's ``constrain_safe``."""
        if not is_dtensor(x):
            return x
        return x.redistribute(
            x.device_mesh, self.sharding(names, x.shape).dtensor_placements())
