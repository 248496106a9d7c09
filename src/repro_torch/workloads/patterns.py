"""The workload-pattern names and their validators.

The port's own copy of the reference registry, so a spec file names the
same patterns and fails with the same errors in both packages.  The
registry is mutable: :func:`register_pattern` (called by
:func:`repro_torch.workloads.programs.register_program_builder`) adds a
name.  The engine runs ``ENGINE_PATTERNS``; :func:`check_engine_pattern`
says what is still to come.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "BERNOULLI_PATTERNS",
    "COLLECTIVE_PATTERNS",
    "ARRIVAL_PATTERNS",
    "ENGINE_ONLY_PATTERNS",
    "SCHEDULES",
    "ENGINE_PATTERNS",
    "pattern_kinds",
    "register_pattern",
    "check_pattern",
    "check_engine_pattern",
    "check_schedule",
    "check_arrival",
    "bounded_pareto_mean",
]

# open-loop Bernoulli injection (drawn fresh each slot, driven by ``load``)
BERNOULLI_PATTERNS = ("uniform", "rep", "rsp", "bu", "mice_elephant",
                      "tornado", "shift", "hotspot", "bursty")
# finite programs measured to completion
COLLECTIVE_PATTERNS = ("all2all", "allreduce", "ring_allreduce",
                       "rd_allreduce")
# open-loop arrival processes (serving traffic; engine pattern "arrival")
ARRIVAL_PATTERNS = ("poisson", "pareto", "diurnal")
# engine-level patterns the spec layer never names directly
ENGINE_ONLY_PATTERNS = ("phase", "program", "arrival")
# collective execution schedules ("" = per-pattern default)
SCHEDULES = ("", "barrier", "window")

# what the port's engine runs: "arrival" comes with the open loop
ENGINE_PATTERNS = BERNOULLI_PATTERNS + ("all2all", "phase", "program")

# mutable: registered collectives (register_pattern) join the built-ins
_KINDS = (
    {p: "bernoulli" for p in BERNOULLI_PATTERNS}
    | {p: "collective" for p in COLLECTIVE_PATTERNS}
    | {p: "arrival" for p in ARRIVAL_PATTERNS}
    | {p: "engine" for p in ENGINE_ONLY_PATTERNS}
)


def pattern_kinds() -> dict:
    """``{pattern name: kind}`` for every pattern of the registry."""
    return dict(_KINDS)


def register_pattern(name: str, kind: str = "collective",
                     *, overwrite: bool = False) -> None:
    """Register a new pattern name.  Spec-level collectives also need a
    program builder (use
    :func:`repro_torch.workloads.programs.register_program_builder`,
    which calls this)."""
    if kind not in ("bernoulli", "collective", "arrival", "engine"):
        raise ValueError(f"unknown pattern kind {kind!r}")
    if name in _KINDS and not overwrite:
        raise ValueError(f"pattern {name!r} already registered "
                         f"({_KINDS[name]})")
    _KINDS[name] = kind


def check_pattern(name: str, *, engine: bool = False) -> str:
    """Validate ``name`` and return its kind.

    ``engine=True`` accepts what the simulator's ``Traffic`` names
    (Bernoulli families, ``all2all`` and the engine-only patterns);
    ``engine=False`` what a ``WorkloadSpec`` may declare (Bernoulli,
    arrival and collective families).
    """
    kind = _KINDS.get(name)
    ok = (kind == "bernoulli"
          or (engine and (kind == "engine" or name == "all2all"))
          or (not engine and kind in ("collective", "arrival")))
    if not ok:
        if engine:
            known = tuple(sorted(n for n, k in _KINDS.items()
                                 if k in ("bernoulli", "engine")
                                 or n == "all2all"))
        else:
            known = tuple(sorted(n for n, k in _KINDS.items()
                                 if k != "engine"))
        hint = ""
        if not engine and kind == "engine":
            hint = (" (engine-only pattern: reach it via a collective such "
                    "as pattern='allreduce')")
        if engine and kind == "arrival":
            hint = (" (arrival family: the engine runs it as "
                    f"Traffic('arrival', process={name!r}))")
        raise ValueError(f"unknown pattern {name!r}; expected one of "
                         f"{known}{hint}")
    return kind


def check_engine_pattern(name: str) -> None:
    """Raise unless the port's engine runs ``name``."""
    check_pattern(name, engine=True)
    if name not in ENGINE_PATTERNS:
        raise NotImplementedError(
            f"pattern {name!r} is not ported yet: the PyTorch engine runs "
            f"{ENGINE_PATTERNS} only; the arrival processes come with the "
            "open loop (ROADMAP item 7)")


def bounded_pareto_mean(alpha: float, cap: int) -> float:
    """Mean of ``floor(X)`` for ``X ~`` bounded Pareto(``alpha``) on
    ``[1, cap]``."""
    if cap <= 1:
        return 1.0
    k = np.arange(1, cap + 1, dtype=np.float64)
    cdf = (1.0 - k ** -alpha) / (1.0 - float(cap) ** -alpha)
    pk = np.diff(np.concatenate([cdf, [1.0]]))     # P(floor(X) = k)
    return float((np.arange(1, cap + 1) * pk).sum())


def check_arrival(process: str, load: float, *, pareto_alpha: float = 1.5,
                  pareto_cap: int = 64, diurnal_amp: float = 0.5,
                  diurnal_period: int = 512, arr_depth: int = 8) -> None:
    """Reject degenerate arrival-process settings."""
    if process not in ARRIVAL_PATTERNS:
        raise ValueError(f"unknown arrival process {process!r}; expected "
                         f"one of {ARRIVAL_PATTERNS}")
    if load <= 0:
        raise ValueError(f"arrival rate (load) must be > 0, got {load}")
    if arr_depth < 1:
        raise ValueError(f"arr_depth must be >= 1, got {arr_depth}")
    if process == "poisson" and load > 1.0:
        raise ValueError(
            f"poisson load {load} > 1 packet/slot/endpoint: the slotted "
            "source generates at most one arrival per endpoint per slot")
    if process == "pareto":
        if pareto_alpha <= 1.0:
            raise ValueError(
                f"pareto_alpha must be > 1 (alpha <= 1 has no finite "
                f"unbounded mean to calibrate against), got {pareto_alpha}")
        if pareto_cap < 1:
            raise ValueError(f"pareto_cap must be >= 1 packet, got "
                             f"{pareto_cap}")
        p_arr = load / bounded_pareto_mean(pareto_alpha, pareto_cap)
        if p_arr > 1.0:
            raise ValueError(
                f"pareto load {load} needs batch-arrival probability "
                f"{p_arr:.3f} > 1 (mean batch {load / p_arr:.2f} "
                "packets): unreachable — lower load or raise "
                "pareto_cap/alpha")
    if process == "diurnal":
        if diurnal_period < 2:
            raise ValueError(
                f"diurnal_period must be >= 2 slots, got {diurnal_period} "
                "(a shorter period cannot represent one modulation cycle)")
        if not 0.0 <= diurnal_amp <= 1.0:
            raise ValueError(f"diurnal_amp must be in [0, 1], got "
                             f"{diurnal_amp}")
        peak = load * (1.0 + diurnal_amp)
        if peak > 1.0:
            raise ValueError(
                f"diurnal peak rate {peak:.3f} > 1 packet/slot/endpoint: "
                "the slotted source would clip the crest and silently "
                "undershoot the offered load")


def check_schedule(schedule: str, window: int) -> None:
    """Validate a collective ``schedule``/``window`` pair."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{SCHEDULES}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window != 1 and schedule != "window":
        raise ValueError(
            f"window={window} requires schedule='window' (got "
            f"schedule={schedule!r})")
