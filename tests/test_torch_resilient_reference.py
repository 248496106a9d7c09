"""The port's resumable experiments, CLI and supervisor against the
reference, and a real SIGKILL.

* ``run_resumable`` of every experiment of
  ``examples/specs/tiny_mrls_a2a.json`` and ``tiny_workloads.json``
  (the collectives in chunks of 4 slots), a latency experiment and the
  pareto point of ``tiny_serving.json``
  (scalar, and at two replicas where the metric has a batched path):
  ``experiment.json`` and ``result.json`` equal what
  ``repro.api.run_resumable`` writes, and the Result equals
  ``repro_torch.api.run``'s;
* ``resume`` of a directory cut back to a middle snapshot, and of a
  finished one;
* the refusals, each with the reference's message: a directory that
  holds another experiment, the ``resilience`` metric, and the CLI's
  ``run --ckpt-dir`` of a multi-experiment spec (exit code 2);
* the CLI's ``run --ckpt-dir`` and ``resume`` records equal ``python -m
  repro.api``'s;
* the supervisor (timeout, RSS budget, injected kill, admission
  preflight, retries exhausted with backoff), as the reference's tests
  run it;
* ``python -m repro_torch.api run ... --device cpu --ckpt-dir D
  --ckpt-every 1`` SIGKILLed as soon as its first snapshot is seen (on
  progress, never on a timer), then ``resume(D)`` equals
  ``repro.api.run``; and the same run under the supervisor, killed at
  its second snapshot by a ``popen`` wrapper and finished by the retry.

Tolerance: zero.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import repro.api as jax_api
import repro_torch.api as port_api
from repro.api.cli import main as jax_cli_main
from repro_torch.api.__main__ import main as cli_main
from repro_torch.checkpointing import Checkpointer
from repro_torch.runtime.fault_tolerance import BackoffPolicy
from repro_torch.runtime.supervisor import (AdmissionRefused, Supervisor,
                                            SupervisorConfig)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"
_PY = sys.executable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _experiments() -> dict:
    """``{name: experiment dict}``: the tiny specs' experiments (the
    collectives in chunks of 4 slots, so that each takes several
    segments), a latency run and the pareto serving point."""
    out = {"a2a": dict(json.loads((SPECS / "tiny_mrls_a2a.json")
                                  .read_text()), chunk=4)}
    for d in json.loads((SPECS / "tiny_workloads.json").read_text())[
            "experiments"]:
        if "max_slots" in d:
            d = dict(d, chunk=4)
        out[d["name"].split(".", 1)[1]] = d
    out["latency"] = dict(out["tornado"], name="tiny.latency",
                          metric="latency")
    pareto = json.loads((SPECS / "tiny_serving.json").read_text())[
        "servings"][1]
    out["pareto"] = {
        "name": "tiny.pareto", "network": pareto["network"],
        "route": pareto["route"], "warm": pareto["warm"],
        "measure": pareto["measure"],
        "workload": {"pattern": "pareto", "load": pareto["loads"][0],
                     "pareto_alpha": pareto["pareto_alpha"],
                     "pareto_cap": pareto["pareto_cap"]}}
    return out


EXPERIMENTS = _experiments()
# every experiment once, and at two replicas each metric's batched path
CASES = [(name, 1) for name in EXPERIMENTS] + [
    (name, 2) for name in ("a2a", "tornado", "latency", "pareto",
                           "all2all_windowed")]
# the segment length: chunks of a completion run, slots of a window
EVERY = {"completion": 1, "throughput": 16, "latency": 16, "serving": 16}


def _pair(name, replicas=1):
    d = dict(EXPERIMENTS[name], replicas=replicas)
    return jax_api.Experiment.from_dict(d), port_api.Experiment.from_dict(d)


def _record(result) -> dict:
    return json.loads(result.to_json())


@pytest.mark.parametrize("name,replicas", CASES,
                         ids=[f"{n}-r{r}" for n, r in CASES])
def test_run_resumable_writes_the_reference_files(tmp_path, name, replicas):
    jexp, pexp = _pair(name, replicas)
    every = EVERY[pexp.resolved_metric()]
    want = jax_api.run_resumable(jexp, str(tmp_path / "jax"), every=every,
                                 keep=100)
    got = port_api.run_resumable(pexp, str(tmp_path / "port"), every=every,
                                 keep=100, device="cpu")
    assert _record(got) == _record(want)
    assert _record(got) == _record(port_api.run(pexp, device="cpu"))
    for fname in ("experiment.json", "result.json"):
        assert (json.loads((tmp_path / "port" / fname).read_text())
                == json.loads((tmp_path / "jax" / fname).read_text())), fname
    steps = Checkpointer(str(tmp_path / "port")).all_steps()
    assert steps == Checkpointer(str(tmp_path / "jax")).all_steps()
    assert len(steps) > 1


@pytest.mark.parametrize("name", ["ring_allreduce", "hotspot", "pareto"])
def test_resume_of_a_cut_back_directory(tmp_path, name):
    _, exp = _pair(name)
    every = EVERY[exp.resolved_metric()]
    full = port_api.run_resumable(exp, str(tmp_path), every=every, keep=100,
                                  device="cpu")
    steps = Checkpointer(str(tmp_path)).all_steps()
    assert len(steps) >= 3
    # a finished directory reports its Result without running
    assert _record(port_api.resume(str(tmp_path))) == _record(full)
    (tmp_path / "result.json").unlink()
    for s in steps[len(steps) // 2:]:
        shutil.rmtree(tmp_path / f"step_{s:010d}")
    again = port_api.resume(str(tmp_path), every=every, device="cpu")
    assert _record(again) == _record(full)
    assert Checkpointer(str(tmp_path)).all_steps()[-1] == steps[-1]


def test_refusals_carry_the_reference_messages(tmp_path, capsys):
    a = _pair("tornado")
    b = _pair("hotspot")
    msgs = []
    for i, name in enumerate(("jax", "port")):
        d = str(tmp_path / name)
        api = jax_api if name == "jax" else port_api
        kw = {} if name == "jax" else {"device": "cpu"}
        api.run_resumable(a[i], d, every=30, **kw)
        with pytest.raises(ValueError, match="different experiment") as e:
            api.run_resumable(b[i], d, every=30, **kw)
        msgs.append(str(e.value).replace(d, "<dir>"))
    assert msgs[0] == msgs[1]

    failing = dict(EXPERIMENTS["tornado"], network=dict(
        EXPERIMENTS["tornado"]["network"], failures={"events": [
            {"kind": "link", "id": 0, "down_slot": 1}]}))
    errors = []
    for api, kw in ((jax_api, {}), (port_api, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not resumable") as e:
            api.run_resumable(api.Experiment.from_dict(failing),
                              str(tmp_path / "res"), **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not (tmp_path / "res").exists()

    with pytest.raises(FileNotFoundError, match="not a resumable"):
        port_api.resume(str(tmp_path / "nothing"))

    spec = str(SPECS / "tiny_workloads.json")
    outs = []
    for main, extra in ((jax_cli_main, []), (cli_main, ["--device", "cpu"])):
        assert main(["run", spec, "--ckpt-dir", str(tmp_path / "cli")]
                    + extra) == 2
        outs.append(capsys.readouterr().err)
    assert outs[0] == outs[1] == \
        "--ckpt-dir needs a single-experiment spec (got 6)\n"
    assert not (tmp_path / "cli").exists()


@pytest.mark.parametrize("name", ["a2a", "allreduce_windowed", "pareto"])
def test_cli_run_ckpt_dir_and_resume_equal_the_reference(tmp_path, capsys,
                                                         name):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(EXPERIMENTS[name]))
    every = str(EVERY[_pair(name)[1].resolved_metric()])
    assert jax_cli_main(["run", str(spec), "--ckpt-dir",
                         str(tmp_path / "jax"), "--ckpt-every", every,
                         "--out", str(tmp_path / "jax.json")]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    assert cli_main(["run", str(spec), "--device", "cpu", "--ckpt-dir",
                     str(tmp_path / "port"), "--ckpt-every", every,
                     "--out", str(tmp_path / "port.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    capsys.readouterr()
    assert [got] == want
    # resume of the finished run, and of the run cut back to its first
    # snapshot
    assert cli_main(["resume", str(tmp_path / "port"), "--out",
                     str(tmp_path / "again.json")]) == 0
    assert json.loads(capsys.readouterr().out) == got
    (tmp_path / "port" / "result.json").unlink()
    first = Checkpointer(str(tmp_path / "port")).all_steps()[0]
    for d in (tmp_path / "port").glob("step_*"):
        if int(d.name[5:]) > first:
            shutil.rmtree(d)
    assert cli_main(["resume", str(tmp_path / "port"), "--device", "cpu",
                     "--ckpt-every", every]) == 0
    assert json.loads(capsys.readouterr().out) == got
    assert jax_cli_main(["resume", str(tmp_path / "jax"), "--out",
                         str(tmp_path / "jax2.json")]) == 0
    assert json.loads((tmp_path / "jax2.json").read_text()) == [got]


# ---------------------------------------------------------------------- #
# supervisor
# ---------------------------------------------------------------------- #
def _sup(**kw):
    kw.setdefault("poll_interval_s", 0.05)
    kw.setdefault("backoff", BackoffPolicy(base_s=0.0, jitter=0.0))
    return Supervisor(SupervisorConfig(**kw), sleep_fn=lambda d: None)


def test_supervisor_timeout_kill():
    res = _sup(timeout_s=0.3, max_retries=0).run(
        [_PY, "-c", "import time; time.sleep(30)"])
    assert not res.ok
    assert res.attempts[0].killed == "timeout"
    assert res.attempts[0].wall_s < 5


def test_supervisor_rss_kill():
    res = _sup(rss_budget_bytes=120 << 20, max_retries=0).run(
        [_PY, "-c",
         "b = bytearray(300 * 2**20); import time; time.sleep(30)"])
    assert not res.ok
    assert res.attempts[0].killed == "rss"
    assert res.peak_rss_bytes > 120 << 20


def test_supervisor_injected_kill_then_success():
    res = _sup(inject_kill_s=0.1, max_retries=2).run(
        [_PY, "-c", "import time; time.sleep(1.0)"])
    assert res.ok and res.retries == 1
    assert res.attempts[0].killed == "injected"
    assert res.attempts[1].ok
    assert res.to_dict()["retries"] == 1


def test_supervisor_admission_preflight():
    sup = _sup(rss_budget_bytes=100)
    with pytest.raises(AdmissionRefused):
        sup.run([_PY, "-c", "pass"], predicted_bytes=200)


def test_supervisor_retries_exhaust_with_backoff():
    slept = []
    sup = Supervisor(
        SupervisorConfig(max_retries=2, poll_interval_s=0.05,
                         backoff=BackoffPolicy(base_s=0.25, jitter=0.0)),
        sleep_fn=slept.append)
    res = sup.run([_PY, "-c", "raise SystemExit(3)"])
    assert not res.ok and len(res.attempts) == 3
    assert all(a.returncode == 3 for a in res.attempts)
    assert slept == [0.25, 0.5]


# ---------------------------------------------------------------------- #
# a real SIGKILL, on progress
# ---------------------------------------------------------------------- #
# the ring allreduce in chunks of 4 slots: dozens of one-chunk segments
KILL_SPEC = EXPERIMENTS["ring_allreduce"]
CHILD_S = 120          # the child's own limit


def _child_argv(spec, ckpt) -> list:
    return [_PY, "-m", "repro_torch.api", "run", str(spec), "--device",
            "cpu", "--ckpt-dir", str(ckpt), "--ckpt-every", "1"]


def _child_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _wait_for_snapshot(ckpt: pathlib.Path, n: int, proc, deadline: float):
    """Poll until ``ckpt`` holds ``n`` snapshots; ``False`` if ``proc``
    ended first."""
    while time.monotonic() < deadline:
        if len(list(ckpt.glob("step_*"))) >= n:
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.005)
    raise TimeoutError(f"no snapshot {n} in {ckpt} within the limit")


def test_sigkill_on_the_first_snapshot_then_resume(tmp_path):
    spec, ckpt = tmp_path / "spec.json", tmp_path / "ckpt"
    spec.write_text(json.dumps(KILL_SPEC))
    proc = subprocess.Popen(_child_argv(spec, ckpt), cwd=ROOT,
                            env=_child_env(), stdout=subprocess.DEVNULL)
    try:
        seen = _wait_for_snapshot(ckpt, 1, proc,
                                  time.monotonic() + CHILD_S)
        if seen:
            os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None and not seen:
            proc.kill()
        proc.wait(timeout=CHILD_S)
    assert seen and proc.returncode == -signal.SIGKILL
    assert not (ckpt / "result.json").exists()
    assert Checkpointer(str(ckpt)).latest_step() >= 1
    got = port_api.resume(str(ckpt), every=1, device="cpu")
    want = jax_api.run(jax_api.Experiment.from_dict(KILL_SPEC))
    assert _record(got) == _record(want)


class _KillAtSnapshot:
    """A ``Supervisor(popen=...)`` that SIGKILLs the first child once the
    checkpoint directory holds ``n`` snapshots, and records at each
    attempt's start the latest snapshot and whether ``result.json``
    exists."""

    def __init__(self, ckpt: pathlib.Path, n: int):
        self.ckpt, self.n = ckpt, n
        self.starts = []
        self.watcher = None

    def __call__(self, argv, **kw):
        steps = Checkpointer(str(self.ckpt)).all_steps() \
            if self.ckpt.exists() else []
        self.starts.append((steps[-1] if steps else None,
                            (self.ckpt / "result.json").exists()))
        proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, **kw)
        if len(self.starts) == 1:
            def watch():
                if _wait_for_snapshot(self.ckpt, self.n, proc,
                                      time.monotonic() + CHILD_S):
                    proc.send_signal(signal.SIGKILL)
            self.watcher = threading.Thread(target=watch, daemon=True)
            self.watcher.start()
        return proc


def test_supervised_run_killed_at_its_second_snapshot_resumes(tmp_path):
    spec, ckpt = tmp_path / "spec.json", tmp_path / "ckpt"
    spec.write_text(json.dumps(KILL_SPEC))
    popen = _KillAtSnapshot(ckpt, 2)
    sup = Supervisor(SupervisorConfig(timeout_s=CHILD_S, max_retries=2,
                                      poll_interval_s=0.05),
                     popen=popen, sleep_fn=lambda d: None)
    res = sup.run(_child_argv(spec, ckpt), cwd=str(ROOT), env=_child_env())
    popen.watcher.join(timeout=CHILD_S)
    assert not popen.watcher.is_alive()
    assert res.ok and len(res.attempts) == 2
    assert res.attempts[0].returncode == -signal.SIGKILL
    assert res.attempts[0].killed is None     # killed by the wrapper
    assert popen.starts[0] == (None, False)
    assert popen.starts[1][0] >= 2 and popen.starts[1][1] is False
    got = json.loads((ckpt / "result.json").read_text())
    want = jax_api.run(jax_api.Experiment.from_dict(KILL_SPEC))
    assert got == _record(want)
    assert dataclasses.asdict(res.attempts[1])["returncode"] == 0
