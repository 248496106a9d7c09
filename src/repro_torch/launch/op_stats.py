"""Per-device cost accounting of one traced step: the port of the
reference's ``launch/hlo_stats.py``.

The reference parses the compiled per-device HLO module and walks its
call graph, multiplying each ``while`` body by its trip count.  The port
has no compiled module: the step runs once, eagerly, on ``meta`` tensors
(shapes, no data), and :class:`OpStats`, a ``TorchDispatchMode``, sees
every PyTorch operation it runs.  A Python loop over layers runs each
layer's operations, so there are no trip counts to recover.

On a model laid out over ranks, the operations are those of DTensors.
The mode declines a DTensor operation (returns ``NotImplemented``), so
that DTensor dispatches it and the local operations it runs on this
rank's shards, and the functional collectives it inserts, come back
through the mode: every count is per device, at local shapes, as the
reference's per-device SPMD module is.  DTensor's own shape propagation
(fake tensors) is not counted.

Per device it counts:

* ``flops``: the formulas of ``torch.utils.flop_counter`` (matrix
  products, attention) at local shapes, plus the work each hand kernel
  records on ``meta`` (``kernels._work``), since a kernel launched
  through ctypes is no PyTorch operation; ``flops_by_op`` keeps them
  apart (``gemm_flops``: ``aten.mm`` / ``bmm`` / ``addmm`` only);
* ``bytes``: operand and result bytes of every operation that is not a
  view, the kernels' recorded bytes, and twice the operand bytes of a
  collective (``hlo_stats``' charge);
* ``collective_bytes`` / ``collective_count`` by the reference's type
  names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``): the operand bytes of each
  functional collective DTensor calls, counted by the op called (before
  a backend's fallback: the all-gather by which DTensor's shard-dim
  all-to-all stands in on a CPU mesh counts as that all-to-all, with its
  input's bytes), none for a group of one rank;
* ``collective_total``;
* ``peak_live_bytes``: the most bytes that the results of the step's
  operations held at once (storages still referenced), which stands in
  for XLA's ``temp_bytes``.

:func:`cost_analysis_dict` is the one-call total that ``hlo_stats``'
namesake gives: ``{"flops", "bytes accessed"}`` of a traced callable.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _work

__all__ = ["COLLECTIVES", "GEMM_OPS", "OpStats", "cost_analysis_dict"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives' op names, by the reference's type names
_COLLECTIVE_OPS = (("all_reduce", "all-reduce"),
                   ("all_gather", "all-gather"),
                   ("reduce_scatter", "reduce-scatter"),
                   ("all_to_all", "all-to-all"),
                   ("permute", "collective-permute"))
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# a collective's completion, and the autograd wrapper of its result: no
# data moves
_NO_WORK = ("wait_tensor", "_wrap_tensor_autograd")
GEMM_OPS = ("aten.mm", "aten.bmm", "aten.addmm")
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args, kwargs) -> int:
    """The ranks of the group a functional collective runs over (its
    group name, the last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size() if names else 1


def _inside(function: str, depth: int = 40) -> bool:
    """Whether a caller within ``depth`` frames is ``function``: DTensor
    moves a split between dims with ``shard_dim_alltoall``, which on a
    CPU mesh calls an all-gather and keeps its own chunk; that call is
    counted as the all-to-all it stands for."""
    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name == function:
            return True
        frame = frame.f_back
    return False


class OpStats(TorchDispatchMode):
    """The accountant: enter it around one step; read :meth:`result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_op = defaultdict(float)
        self.kernel_launches = defaultdict(int)
        self.collective_bytes = defaultdict(float)
        self.collective_count = defaultdict(int)
        self.n_ops = 0
        self.read: set = set()
        self._live: dict = {}
        self._live_bytes = 0
        self._peak = 0
        self._listen = None
        from torch._subclasses.fake_tensor import FakeTensor
        self._fake = FakeTensor
        self._dtensor = ()                  # issubclass(t, ()) is False
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor

    # ------------------------------------------------------------------ #
    def __enter__(self):
        self._listen = _work.listening(self._kernel)
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listen.__exit__(*exc)

    def _kernel(self, name: str, flops: float, n_bytes: float) -> None:
        self.flops += flops
        self.flops_by_op[name] += flops
        self.bytes += n_bytes
        self.kernel_launches[name] += 1

    # ------------------------------------------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        out = func(*args, **kwargs)
        # DTensor's shape propagation runs on fake tensors: not counted
        if not torch._C._meta_in_tls_dispatch_include() and not any(
                isinstance(t, self._fake) for t in _tensors((args, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._opname
        if ns in _NAMESPACES:
            if name in _NO_WORK:
                return
            kind = next((k for key, k in _COLLECTIVE_OPS if key in name),
                        None)
            if kind == "all-gather" and _inside("shard_dim_alltoall"):
                kind = "all-to-all"     # DTensor's CPU stand-in for it
            if kind is None:
                raise NotImplementedError(
                    f"op_stats has no collective type for {func}")
            self._reads(args)
            if _group_size(args, kwargs) > 1:
                b = sum(_nbytes(t) for t in _tensors(args))
                self.collective_bytes[kind] += b
                self.collective_count[kind] += 1
                self.bytes += 2 * b
            return
        self.n_ops += 1
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[f"{ns}.{name}"] += f
        if func.is_view:
            return
        self._reads(args)
        outs = list(_tensors(out))
        if name in _ALLOCATIONS:            # storage, no data written
            self._track(outs)
            return
        self.bytes += sum(_nbytes(t) for t in _tensors(args)) + \
            sum(_nbytes(t) for t in outs)
        self._track(outs)

    def _reads(self, args) -> None:
        """Note the storages an operation reads (a view reads nothing)."""
        for t in _tensors(args):
            self.read.add(t.untyped_storage()._cdata)

    def _track(self, outs) -> None:
        """Add each new storage among ``outs`` to the live set and update
        the peak (storages no longer referenced dropped first)."""
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in outs:
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            old = self._live.get(ref.cdata)
            if old is not None:
                if not old[0].expired():
                    continue
                self._live_bytes -= old[1]      # its address, reused
            self._live[ref.cdata] = (ref, st.nbytes())
            self._live_bytes += st.nbytes()
        if self._live_bytes > self._peak:
            for key, (ref, n) in list(self._live.items()):
                if ref.expired():
                    del self._live[key]
                    self._live_bytes -= n
            self._peak = max(self._peak, self._live_bytes)

    # ------------------------------------------------------------------ #
    @property
    def gemm_flops(self) -> float:
        return sum(self.flops_by_op.get(k, 0.0) for k in GEMM_OPS)

    def result(self) -> dict:
        """The counts, in ``hlo_stats.analyze``'s keys and more."""
        cb = {k: self.collective_bytes[k] for k in COLLECTIVES
              if k in self.collective_bytes}
        return {"flops": self.flops, "bytes": self.bytes,
                "gemm_flops": self.gemm_flops,
                "flops_by_op": dict(self.flops_by_op),
                "kernel_launches": dict(self.kernel_launches),
                "collective_bytes": cb,
                "collective_count": {k: self.collective_count[k]
                                     for k in cb},
                "collective_total": sum(cb.values()),
                "peak_live_bytes": self._peak,
                "n_ops": self.n_ops}


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """``{"flops", "bytes accessed"}`` of one call of ``fn(*args,
    **kwargs)`` under :class:`OpStats` (the role of ``hlo_stats``'
    ``cost_analysis_dict``: a total, without the per-op record)."""
    with OpStats() as stats:
        fn(*args, **kwargs)
    return {"flops": stats.flops, "bytes accessed": stats.bytes}
