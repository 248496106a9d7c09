"""Atomic checkpoints of tensor trees, in the reference's on-disk layout.

* Atomic: written to ``<dir>/tmp.<step>`` then renamed to
  ``<dir>/step_%010d``, so a crash mid-save never corrupts the latest
  checkpoint; stale ``tmp.*`` directories are removed when a directory
  is opened.
* Host copy first: ``save`` and ``save_async`` copy every leaf to fresh
  host memory before they return (on the CPU, ``tensor.numpy()`` shares
  the tensor's storage, and the engine writes its state in place, so an
  aliased snapshot would silently become a later state); ``save_async``
  then writes in a background thread.
* Bounded retention: the ``keep`` newest checkpoints survive.

Storage: ``arrays.npz`` with one entry per leaf, keyed by its path in
the tree (sorted dict keys and sequence indices joined by ``/``, e.g.
``state/ejected``), beside ``meta.json`` (``step``, ``dtypes`` and the
caller's fields).  ``.npz`` has no bfloat16: such tensors are stored as
``uint16`` views and named ``"bfloat16"`` in ``meta["dtypes"]``, so the
files read the same in the reference's ``Checkpointer`` and here.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.sharding import place_tree

__all__ = ["Checkpointer"]


def _leaves(tree, prefix=()):
    """``(path, leaf)`` in the reference's flattening order: dict keys
    sorted, sequences by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _rebuild(template, flat: dict, device, prefix=()):
    """``template``'s structure with each leaf taken from ``flat``
    (``path -> (stored array, dtype name)``)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, device, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, device, prefix + (str(i),))
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    return _as_leaf(*flat[key], template, device)


def _to_host(leaf):
    """``(numpy array in fresh memory, dtype name or None)``; bfloat16 as
    a ``uint16`` view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).to("cpu", copy=True).numpy()
                    .view(np.uint16), "bfloat16")
        return t.to("cpu", copy=True).numpy(), None
    return np.array(leaf, copy=True), None


def _as_leaf(a: np.ndarray, dname: Optional[str], leaf, device):
    """The stored array ``a`` as the template's ``leaf`` is: a contiguous
    tensor of the leaf's dtype on ``device`` (default: the leaf's), else
    the numpy array (a CPU tensor for bfloat16, which numpy lacks)."""
    is_tensor = isinstance(leaf, torch.Tensor)
    if dname == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif not is_tensor:
        return a
    elif leaf.dtype == torch.bfloat16:
        raise TypeError(f"a torch.bfloat16 leaf stored as {a.dtype}")
    else:
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        t = torch.from_numpy(a.astype(np_dtype, copy=False))
    if not is_tensor:
        return t
    if t.dtype != leaf.dtype:
        raise TypeError(f"a {leaf.dtype} leaf stored as bfloat16")
    return t.to(device if device is not None else leaf.device).contiguous()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # a SIGKILL mid-save leaves a tmp.<step> behind; it never shadows
        # a finished checkpoint (only the rename publishes), but stale
        # partial writes would pile up across supervised retries
        for name in os.listdir(directory):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------ #
    def _write(self, step: int, host_tree: dict, meta: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host_tree)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def _snapshot(self, tree, meta):
        host, dtypes = {}, {}
        for k, v in _leaves(tree):
            host[k], dname = _to_host(v)
            if dname:
                dtypes[k] = dname
        return host, {"dtypes": dtypes, **meta}

    def save(self, step: int, tree, meta: Optional[dict] = None):
        host, m = self._snapshot(tree, {"step": step, **(meta or {})})
        self._write(step, host, m)

    def save_async(self, step: int, tree, meta: Optional[dict] = None):
        self.wait()
        host, m = self._snapshot(tree, {"step": step, **(meta or {})})
        self._thread = threading.Thread(
            target=self._write, args=(step, host, m), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, step: Optional[int] = None,
                device=None, shardings=None) -> tuple[Any, dict]:
        """Load into the structure of ``template``: a tensor leaf comes
        back as a contiguous tensor of its dtype on its device (on
        ``device`` if given), any other leaf as the stored numpy array;
        with ``shardings`` (a tree of ``parallel.sharding.Placement``s of
        the same structure) each tensor is then re-placed, elastic across
        meshes.  Returns ``(tree, meta)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: (data[k], dtypes.get(k)) for k in data.files}
        tree = _rebuild(template, flat, device)
        if shardings is not None:
            tree = place_tree(tree, shardings)
        return tree, meta
