"""Cartesian sweeps over experiment axes.

The port's own copy of the reference's ``api.sweep``.  ``sweep(base,
axes)`` expands ``axes`` — a mapping of dotted spec paths
(``workload.load``, ``route.policy``, ``seed``, ``network.params.u``, ...)
to value lists — into the full grid, runs every point through
:func:`repro_torch.api.run_all`, and returns one :class:`Result` per
point in row-major order (last axis fastest).  Grid points that share a
``(network, route)`` pair reuse one simulator via
:class:`SimulatorCache`; axes are ordered so fabric-changing axes vary
slowest (maximizing reuse runs between rebuilds) and a ``seed`` axis
varies fastest (``run_all`` folds such a stretch into one batched
run).
"""
from __future__ import annotations

import itertools
from typing import Mapping, Optional, Sequence

from .runner import SimulatorCache, run_all
from .specs import Experiment

__all__ = ["expand_axes", "sweep"]

# axes that force a new compiled simulator — keep them outermost
_FABRIC_PREFIXES = ("network.", "route.")


def _axis_order(axes: Mapping[str, Sequence]) -> list:
    names = list(axes)
    fabric = sorted(n for n in names if n.startswith(_FABRIC_PREFIXES))
    rest = [n for n in names
            if not n.startswith(_FABRIC_PREFIXES) and n != "seed"]
    # seed varies fastest so consecutive grid points differ only in seed and
    # run_all can fold them into one vmapped batched run
    tail = ["seed"] if "seed" in names else []
    return fabric + rest + tail


def expand_axes(base: Experiment, axes: Mapping[str, Sequence]) -> list:
    """The experiment grid, fabric axes outermost, insertion order inside."""
    if not axes:
        return [base]
    order = _axis_order(axes)
    grid = []
    for values in itertools.product(*(axes[name] for name in order)):
        exp = base
        for name, value in zip(order, values):
            exp = exp.override(name, value)
        if base.name and "name" not in axes:
            # re-label: inheriting the base name verbatim would stamp every
            # grid point with the base's (now wrong) policy/load label
            coords = ", ".join(f"{n}={v}" for n, v in zip(order, values))
            exp = exp.override("name", f"{base.name}[{coords}]")
        grid.append(exp)
    return grid


def sweep(base: Experiment, axes: Mapping[str, Sequence], *,
          cache: Optional[SimulatorCache] = None,
          fold_seeds: bool = True, device=None) -> list:
    """Run the cartesian grid on ``device`` (the card by default);
    returns ``[Result]``, one per grid point.

    With a private cache (none passed in), each fabric's simulator is
    dropped right after its last grid point — fabric axes vary slowest,
    so at most one simulator is live at a time.  ``fold_seeds`` is passed
    to :func:`~repro_torch.api.run_all`.
    """
    return run_all(expand_axes(base, axes), cache=cache,
                   fold_seeds=fold_seeds, device=device)
