"""Subprocess supervisor: watchdog, RSS budget, kill and resume.

Wraps a worker command (a ``python -m repro_torch.api run ... --ckpt-dir
D`` run, or any subprocess that checkpoints its own progress) with the
failure handling a 100k-endpoint run needs:

* **wall-clock watchdog**: a worker that stops making progress is
  SIGKILLed at ``timeout_s``;
* **peak-RSS polling**: ``/proc/<pid>/status`` ``VmRSS``/``VmHWM`` is
  sampled every ``poll_interval_s`` and the worker is SIGKILLed the
  moment its resident memory crosses ``rss_budget_bytes``, so the
  supervisor kills one worker instead of letting the kernel's OOM
  killer pick a victim;
* **admission preflight**: ``run(..., predicted_bytes=...)`` refuses to
  start a worker whose predicted footprint exceeds the budget;
* **retry with deterministic backoff**: failed or killed attempts are
  retried up to ``max_retries`` times, sleeping
  :meth:`BackoffPolicy.delay` between attempts.  Because the worker
  resumes from its checkpoint directory, a retry continues the run
  rather than restarting it, and the resumable runs make the resumed
  result bitwise the uninterrupted one.

Chaos hook: ``inject_kill_s`` SIGKILLs the *first* attempt after a fixed
delay.  ``popen`` is injectable: a wrapper may watch the worker's
progress and kill it itself.

Everything is the standard library and ``/proc``.
"""
from __future__ import annotations

import dataclasses
import signal
import subprocess
import time
from typing import Callable, Optional, Sequence

from .fault_tolerance import BackoffPolicy

__all__ = ["SupervisorConfig", "WorkerAttempt", "SupervisedResult",
           "AdmissionRefused", "read_rss", "Supervisor"]


class AdmissionRefused(RuntimeError):
    """The predicted memory footprint exceeds the budget; the worker was
    never started."""


def read_rss(pid: int) -> tuple[Optional[int], Optional[int]]:
    """``(VmRSS, VmHWM)`` in bytes from ``/proc/<pid>/status``; ``(None,
    None)`` once the process is gone (or on non-Linux hosts)."""
    rss = hwm = None
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
    except OSError:
        pass
    return rss, hwm


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    timeout_s: Optional[float] = None        # wall-clock watchdog per attempt
    rss_budget_bytes: Optional[int] = None   # SIGKILL above this resident set
    poll_interval_s: float = 0.25
    max_retries: int = 3                     # attempts = 1 + max_retries
    backoff: BackoffPolicy = BackoffPolicy()
    inject_kill_s: Optional[float] = None    # chaos: kill attempt 1 after this


@dataclasses.dataclass
class WorkerAttempt:
    """Outcome of one subprocess attempt."""

    returncode: Optional[int]
    wall_s: float
    peak_rss_bytes: Optional[int]
    killed: Optional[str] = None    # None | "timeout" | "rss" | "injected"

    @property
    def ok(self) -> bool:
        return self.returncode == 0 and self.killed is None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SupervisedResult:
    ok: bool
    attempts: list
    total_wall_s: float

    @property
    def retries(self) -> int:
        return max(len(self.attempts) - 1, 0)

    @property
    def peak_rss_bytes(self) -> Optional[int]:
        vals = [a.peak_rss_bytes for a in self.attempts
                if a.peak_rss_bytes is not None]
        return max(vals) if vals else None

    def to_dict(self) -> dict:
        return {"ok": self.ok, "retries": self.retries,
                "total_wall_s": self.total_wall_s,
                "peak_rss_bytes": self.peak_rss_bytes,
                "attempts": [a.to_dict() for a in self.attempts]}


class Supervisor:
    """Run worker commands under watchdog/RSS/retry supervision.

    ``sleep_fn``/``clock`` are injectable for tests (the backoff decision
    path itself is deterministic — see :class:`BackoffPolicy`).
    """

    def __init__(self, cfg: SupervisorConfig = SupervisorConfig(), *,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 popen: Callable = subprocess.Popen):
        self.cfg = cfg
        self.sleep_fn = sleep_fn
        self.popen = popen

    # ------------------------------------------------------------------ #
    def _kill(self, proc) -> None:
        try:
            proc.send_signal(signal.SIGKILL)
        except (ProcessLookupError, OSError):  # pragma: no cover - raced exit
            pass
        proc.wait()

    def _attempt(self, argv: Sequence[str], first: bool, *,
                 env=None, cwd=None) -> WorkerAttempt:
        cfg = self.cfg
        t0 = time.monotonic()
        proc = self.popen(list(argv), env=env, cwd=cwd)
        peak: Optional[int] = None
        injected = cfg.inject_kill_s if first else None
        killed = None
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            rss, hwm = read_rss(proc.pid)
            cand = hwm if hwm is not None else rss
            if cand is not None:
                peak = cand if peak is None else max(peak, cand)
            elapsed = time.monotonic() - t0
            if injected is not None and elapsed >= injected:
                killed = "injected"
            elif (cfg.rss_budget_bytes is not None and cand is not None
                    and cand > cfg.rss_budget_bytes):
                killed = "rss"
            elif cfg.timeout_s is not None and elapsed >= cfg.timeout_s:
                killed = "timeout"
            if killed is not None:
                self._kill(proc)
                rc = proc.returncode
                break
            time.sleep(cfg.poll_interval_s)
        return WorkerAttempt(returncode=rc,
                             wall_s=time.monotonic() - t0,
                             peak_rss_bytes=peak, killed=killed)

    # ------------------------------------------------------------------ #
    def run(self, argv: Sequence[str], *, env=None, cwd=None,
            predicted_bytes: Optional[int] = None) -> SupervisedResult:
        """Run ``argv`` to success, retrying with backoff on failure.

        ``predicted_bytes`` (a memory estimate) is checked against
        the RSS budget *before* the first attempt: a worker predicted to
        blow the budget raises :class:`AdmissionRefused` instead of being
        started and OOM-killed ``max_retries + 1`` times.

        The command must be idempotent-resumable (e.g. carry a
        ``--ckpt-dir`` directory): the supervisor re-execs the same argv and
        relies on the worker to pick up its own checkpoints.
        """
        cfg = self.cfg
        if (predicted_bytes is not None and cfg.rss_budget_bytes is not None
                and predicted_bytes > cfg.rss_budget_bytes):
            raise AdmissionRefused(
                f"predicted peak RSS {predicted_bytes} B exceeds the "
                f"supervisor budget {cfg.rss_budget_bytes} B; not starting "
                "the worker.  Shrink the spec (fewer replicas, smaller "
                "chunk, masks='blocked') or raise the budget.")
        attempts: list[WorkerAttempt] = []
        total = 0
        t0 = time.monotonic()
        while True:
            att = self._attempt(argv, first=not attempts, env=env, cwd=cwd)
            attempts.append(att)
            if att.ok:
                return SupervisedResult(ok=True, attempts=attempts,
                                        total_wall_s=time.monotonic() - t0)
            total += 1
            if total > cfg.max_retries:
                return SupervisedResult(ok=False, attempts=attempts,
                                        total_wall_s=time.monotonic() - t0)
            self.sleep_fn(cfg.backoff.delay(total, total))
