"""Fault tolerance for long runs: checkpoint-restart, straggler
detection and deterministic backoff.

At 100k-endpoint scale node failure is the steady state, not an
exception.  The runner treats a job as a pure function of (checkpoint,
data cursor):

* every ``ckpt_every`` steps: an async checkpoint of the state and step;
* on a step failure (device loss, a non-finite loss, an injected fault):
  restore the latest checkpoint, rebuild the step's data from its cursor
  (the data is counter-based, so the replay is exact) and continue;
* straggler detection: an EMA of each step's wall time and its
  deviation; a step slower than ``straggler_z`` sigmas is flagged and
  counted.

:func:`elastic_reshard` re-places a state onto another mesh after losing
part of the machine, leaf by leaf by its spec's sharding axes; a leaf
that would split over distinct devices is refused (ROADMAP queue 1 item
16).  :class:`FaultTolerantRunner` restores onto ``device`` or onto
``shardings``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from ..checkpointing.checkpoint import Checkpointer
from ..models.common import param_shardings
from ..parallel.sharding import place_tree

__all__ = ["BackoffPolicy", "FTConfig", "StragglerDetector",
           "schedule_fault_hook", "FaultTolerantRunner", "elastic_reshard"]


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with *deterministic* jitter.

    The delay for a retry is ``base_s * factor**(consecutive-1)`` capped
    at ``cap_s``, scaled by a jitter factor drawn from a PRNG seeded on
    ``(seed, total)``: the total failure count is a monotonic counter,
    so no wall-clock read feeds the schedule, and two runs that fail the
    same way sleep the same amounts.
    """

    base_s: float = 0.5
    factor: float = 2.0
    cap_s: float = 30.0
    jitter: float = 0.1      # +/- fraction of the delay
    seed: int = 0

    def delay(self, consecutive: int, total: int) -> float:
        """Sleep before retry number ``consecutive`` (1-based, consecutive
        failures since the last success); ``total`` is the lifetime
        failure count, used only to decorrelate the jitter draw."""
        d = min(self.base_s * self.factor ** max(int(consecutive) - 1, 0),
                self.cap_s)
        if self.jitter:
            u = np.random.default_rng((self.seed, int(total))).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return float(d)


@dataclasses.dataclass
class FTConfig:
    ckpt_every: int = 50
    max_retries: int = 3            # total failures tolerated per run()
    max_consecutive: Optional[int] = None   # default: same as max_retries
    backoff: BackoffPolicy = BackoffPolicy()
    straggler_z: float = 3.0
    ema: float = 0.9

    @property
    def consecutive_limit(self) -> int:
        return (self.max_retries if self.max_consecutive is None
                else self.max_consecutive)


class StragglerDetector:
    WARMUP = 5      # observations before flagging

    def __init__(self, cfg: FTConfig):
        self.cfg = cfg
        self.mean = None
        self.var = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        sd = max(math.sqrt(self.var), 0.05 * self.mean, 1e-9)
        is_straggler = (self.n > self.WARMUP
                        and dt > self.mean + self.cfg.straggler_z * sd)
        a = self.cfg.ema
        # residual against the pre-update mean: updating the mean first
        # would shrink it by the blend factor and bias the variance low
        resid = dt - self.mean
        self.mean = a * self.mean + (1 - a) * dt
        self.var = a * self.var + (1 - a) * resid ** 2
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


def schedule_fault_hook(sim, holder, *, slots_per_step: int = 1):
    """A :attr:`FaultTolerantRunner.fault_hook` that applies a
    simulator's :class:`repro_torch.core.FailureSchedule` on the step
    clock.

    ``sim`` must be armed with a non-empty schedule; ``holder`` is a
    one-element list holding the live state dict.  Before the runner
    executes step ``k``, every transition whose slot is at or before
    ``(k + 1) * slots_per_step`` is applied: the tables' delta rebuild
    (``sim.tables.apply_failures``) is written into the state
    (``sim.update_tables``, in place), and under the ``drop`` policy the
    packets stranded on dead elements are freed
    (``sim.drop_dead_packets``).
    """
    if not getattr(sim, "has_failures", False):
        raise ValueError("schedule_fault_hook needs a simulator armed "
                         "with a non-empty FailureSchedule")
    trans = sim.failures.transitions()
    drop = sim.failures.policy == "drop"
    cursor = [0]

    def hook(step: int) -> None:
        boundary = (step + 1) * slots_per_step
        while cursor[0] < len(trans) and trans[cursor[0]][0] <= boundary:
            _, downs, ups = trans[cursor[0]]
            delta = sim.tables.apply_failures(down=downs, up=ups)
            holder[0] = sim.update_tables(holder[0], delta)
            if drop and downs:
                holder[0] = sim.drop_dead_packets(holder[0])
            cursor[0] += 1

    return hook


class FaultTolerantRunner:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with
    checkpoint-restart.  ``state`` is any tree of tensors;
    ``batch_at(step)`` must be pure (a counter-based pipeline).

    ``fault_hook(step)`` runs *before* each step attempt and is the
    injection point for failures: tests raise from it to exercise the
    restore, and :func:`schedule_fault_hook` puts a simulator's failure
    schedule on the step clock.

    Failures are counted on two clocks: ``total_failures`` (the
    lifetime of a ``run()``, bounded by ``cfg.max_retries``) and
    ``consecutive_failures`` (reset by any successful step, bounded by
    ``cfg.max_consecutive``), so a long job with scattered transients
    goes on while a wedged step fails fast.  Before each restore the
    runner sleeps ``cfg.backoff.delay(consecutive, total)``; ``sleep_fn``
    is injectable so tests assert the delays without sleeping.  A
    restored state goes onto ``device`` (default: the devices of the
    state the runner holds), then onto ``shardings`` (a tree of
    ``parallel.sharding.Placement``s) if given."""

    def __init__(self, step_fn: Callable, batch_at: Callable,
                 ckpt: Checkpointer, cfg: FTConfig = FTConfig(),
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device=None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 shardings=None):
        self.step_fn = step_fn
        self.batch_at = batch_at
        self.ckpt = ckpt
        self.cfg = cfg
        self.fault_hook = fault_hook          # tests inject failures here
        self.device = device
        self.shardings = shardings
        self.sleep_fn = sleep_fn
        self.stragglers = StragglerDetector(cfg)
        self.total_failures = 0
        self.consecutive_failures = 0
        self.delays: list[float] = []         # backoff actually applied

    @property
    def restarts(self) -> int:
        """Lifetime failure count (alias of ``total_failures``)."""
        return self.total_failures

    def _check_health(self, metrics: dict):
        loss = metrics.get("loss")
        if loss is not None and not np.isfinite(float(loss)):
            raise FloatingPointError(f"non-finite loss {loss}")

    def run(self, state, start_step: int, n_steps: int):
        step = start_step
        history = []
        while step < start_step + n_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.perf_counter()
                batch = self.batch_at(step)
                state, metrics = self.step_fn(state, batch)
                self._check_health(metrics)
                dt = time.perf_counter() - t0
                self.stragglers.observe(step, dt)
                history.append({k: float(v) for k, v in metrics.items()})
                step += 1
                self.consecutive_failures = 0
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save_async(step, state)
            except Exception:
                self.total_failures += 1
                self.consecutive_failures += 1
                if (self.total_failures > self.cfg.max_retries
                        or self.consecutive_failures
                        > self.cfg.consecutive_limit):
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                delay = self.cfg.backoff.delay(self.consecutive_failures,
                                               self.total_failures)
                self.delays.append(delay)
                if delay > 0:
                    self.sleep_fn(delay)
                state, meta = self.ckpt.restore(state, latest, self.device,
                                                self.shardings)
                step = meta["step"]
        self.ckpt.wait()
        return state, step, history


def elastic_reshard(tree, new_sharder, specs):
    """Re-place a state tree onto a (possibly different-size) mesh: the
    recovery path after losing part of the machine.  Each tensor goes
    where ``models.common.param_shardings(specs, new_sharder)`` puts it:
    whole onto the one device its resolved axes span; a leaf that would
    split over distinct devices raises ``NotImplementedError``."""
    return place_tree(tree, param_shardings(specs, new_sharder))
