"""The memory estimate and the admission gate of the port.

* ``mask_table_bytes``, ``DENSE_MASK_LIMIT``, ``format_bytes`` and
  ``estimate_memory`` equal the reference's (the search's records and its
  ``mem_budget_mib`` pruning read the estimate): every experiment of
  ``examples/specs``, and the Figure 5/6/7 goldens' experiments, at one
  and four replicas, with and without a failure schedule.
* ``device_bytes``'s resident terms equal the summed ``nbytes`` of the
  tensors that a CPU ``Simulator`` and its states hold, so only the
  transient and floor coefficients are left to the card.
* ``check_admission``: the modes, the memo, the refusal's message, the
  gate in ``run`` / ``run_all`` / ``run_resumable`` before anything is
  built, and the supervisor's preflight.
* The CLI's ``estimate`` against ``python -m repro.api estimate``.

Tolerance: zero.
"""
import dataclasses
import glob
import json
import pathlib
import sys

import pytest
import torch

import repro.api as jax_api
import repro.core.routing as jax_routing
import repro_torch.api as port_api
import repro_torch.core.routing as port_routing
from repro.api.cli import main as jax_cli_main
from repro_torch.api import admission, registry, runner
from repro_torch.api.__main__ import main as cli_main
from repro_torch.api.runner import _make_simulator, _to_traffic
from repro_torch.runtime.supervisor import (AdmissionRefused, Supervisor,
                                            SupervisorConfig)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant",
            "degraded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_memo():
    admission._memo.clear()
    yield
    admission._memo.clear()


def _spec_experiments() -> list:
    """Every experiment dict of ``examples/specs``: experiment files,
    ``{"experiments": [...]}`` lists and the bases of sweep files."""
    out = []
    for path in sorted(glob.glob(str(ROOT / "examples" / "specs" /
                                     "*.json"))):
        doc = json.loads(pathlib.Path(path).read_text())
        if "experiments" in doc:
            out += doc["experiments"]
        elif "base" in doc:
            out.append(doc["base"])
        elif "network" in doc:
            out.append(doc)
    return out


def _golden_experiments() -> list:
    out = []
    for pattern in ("torch_fig5_*.json", "torch_a2a_*.json",
                    "torch_fig7_*.json"):
        for path in sorted(GOLDEN.glob(pattern)):
            doc = json.loads(path.read_text())
            out.append(doc["experiment"])
    return out


def _failures(network: dict) -> dict:
    """``network`` with a two-event schedule on its first links."""
    return dict(network, failures={"events": [
        {"kind": "link", "id": 0, "down_slot": 5, "up_slot": 30},
        {"kind": "link", "id": 1, "down_slot": 10}], "policy": "requeue"})


def test_mask_constants_equal_the_reference():
    assert port_routing.DENSE_MASK_LIMIT == jax_routing.DENSE_MASK_LIMIT
    for n1, n, p in ((1, 1, 1), (14, 21, 6), (5832, 8748, 36),
                     (5832, 23328, 36), (1040, 2080, 32), (7, 9, 33)):
        assert (port_routing.mask_table_bytes(n1, n, p)
                == jax_routing.mask_table_bytes(n1, n, p))
    assert port_routing.POLICIES == jax_routing.POLICIES


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 1536.5, 1 << 20,
                               3 << 29, 5 << 40, 1 << 50, 1 << 62])
def test_format_bytes_equals_the_reference(n):
    assert port_api.format_bytes(n) == jax_api.format_bytes(n)


@pytest.mark.parametrize("source", ["specs", "goldens"])
@pytest.mark.parametrize("replicas", [1, 4])
@pytest.mark.parametrize("failures", [False, True])
def test_estimate_memory_equals_the_reference(source, replicas, failures):
    exps = _spec_experiments() if source == "specs" else \
        _golden_experiments()
    assert len(exps) >= (20 if source == "specs" else 16)
    for d in exps:
        if failures:
            d = dict(d, network=_failures(d["network"]))
        d = dict(d, replicas=replicas)
        ref = jax_api.estimate_memory(jax_api.Experiment.from_dict(d))
        got = port_api.estimate_memory(port_api.Experiment.from_dict(d))
        assert got == ref
        assert got["failures"]["armed"] is failures
    # the NetworkSpec form, with its route and replicas given explicitly
    d = exps[0]
    ref = jax_api.estimate_memory(
        jax_api.NetworkSpec.from_dict(d["network"]),
        jax_api.RouteSpec.from_dict(d.get("route", {})), replicas=replicas)
    got = port_api.estimate_memory(
        port_api.NetworkSpec.from_dict(d["network"]),
        port_api.RouteSpec.from_dict(d.get("route", {})), replicas=replicas)
    assert got == ref


def test_estimate_reads_the_limit_off_the_module(monkeypatch):
    d = _spec_experiments()[0]
    monkeypatch.setattr(jax_routing, "DENSE_MASK_LIMIT", 0)
    monkeypatch.setattr(port_routing, "DENSE_MASK_LIMIT", 0)
    ref = jax_api.estimate_memory(jax_api.Experiment.from_dict(d))
    got = port_api.estimate_memory(port_api.Experiment.from_dict(d))
    assert got == ref and got["tables"]["mask_layout"] == "blocked"


# ---------------------------------------------------------------------- #
# the resident terms against the tensors a CPU simulator holds
# ---------------------------------------------------------------------- #
NETWORKS = {
    "mrls14": {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3}},
    "mrls1k": {"family": "mrls",
               "params": {"n_leaves": 56, "u": 18, "d": 18, "seed": 1}},
    "df422": {"family": "dragonfly", "params": {"a": 4, "p": 2, "h": 2}},
}
WORKLOADS = {
    "uniform": {"pattern": "uniform", "load": 0.5},
    "rep": {"pattern": "rep", "load": 0.5},
    "rsp": {"pattern": "rsp", "load": 0.5},
    "bursty": {"pattern": "bursty", "load": 0.3},
    "pareto": {"pattern": "pareto", "load": 0.3, "arr_depth": 6},
    "allreduce": {"pattern": "allreduce", "ranks": 16, "vec_packets": 4},
}


def _nbytes(tensors) -> int:
    return sum(v.nbytes for v in tensors if torch.is_tensor(v))


def _simulator_nbytes(sim) -> int:
    """The tables' ``dist_leaf`` and every tensor the simulator holds."""
    return sim.tables.dist_leaf.nbytes + _nbytes(vars(sim).values())


def _state(sim, exp, seeds):
    from repro_torch.api.runner import _collective_program, _is_program
    if _is_program(exp):
        cp = _collective_program(sim, exp)
        return (sim.make_program_state(cp, seeds[0]) if len(seeds) == 1
                else sim.make_program_batch_state(cp, seeds))
    tr = _to_traffic(exp)
    return (sim.make_state(tr, seeds[0]) if len(seeds) == 1
            else sim.make_batch_state(tr, seeds))


@pytest.mark.parametrize("net", sorted(NETWORKS))
@pytest.mark.parametrize("policy", POLICIES)
def test_resident_terms_equal_the_simulators_tensors(net, policy):
    network = NETWORKS[net]
    for wname, workload in WORKLOADS.items():
        for armed in (False, True):
            if armed and wname != "uniform":
                continue
            d = {"network": _failures(network) if armed else network,
                 "route": {"policy": policy, "max_hops": 12, "pool": 4096},
                 "workload": workload}
            exp = port_api.Experiment.from_dict(d)
            sim = _make_simulator(exp.network, exp.route,
                                  torch.device("cpu"))
            est = admission.device_bytes(exp, "cpu")
            assert est["simulator_bytes"] == _simulator_nbytes(sim), wname
            one = _state(sim, exp, [3])
            shared = est["program_bytes"]
            assert (_nbytes(one.values())
                    == est["state_bytes_per_replica"] + shared), wname
            many = _state(sim, exp, [0, 1, 2])
            assert (_nbytes(many.values())
                    == 3 * est["state_bytes_per_replica"] + shared), wname
            assert (est["failure_state_bytes_per_replica"] > 0) is armed
            # an armed schedule runs its replicas one after the other
            held = one if armed else many
            resident = dataclasses.replace(exp, replicas=3)
            assert (admission.device_bytes(resident, "cpu")
                    ["resident_bytes"]
                    == _simulator_nbytes(sim) + _nbytes(held.values()))


def test_model_on_the_card_adds_the_build_and_the_allocator():
    """Pricing the card needs no card: the squaring's two padded [N, N]
    int16 matrices, the coefficients and the allocator's floor."""
    exp = port_api.Experiment.from_dict(json.loads(
        (GOLDEN / "torch_a2a_fig6_ft50.json").read_text())["experiment"])
    est = admission.device_bytes(exp, "cuda")
    n, n1, p, s = 23328, 5832, 36, 104976
    assert est["n_endpoints"] == s
    assert est["build_bytes"] >= 2 * n * n * 2
    nrp = (n * p + s) * p
    assert est["step_bytes_per_replica"] == (
        admission.STEP_BYTES_PER_PORT_ROW * nrp)
    raw = max(est["build_bytes"], est["resident_bytes"]
              + est["transient_bytes"], est["simulator_bytes"]
              + est["setup_bytes"])
    assert est["peak_bytes"] == int(raw * (1 + admission.ALLOCATOR_SLACK)
                                    + admission.ALLOCATOR_FLOOR_BYTES)
    assert admission.device_peak_bytes(exp) == est["peak_bytes"]
    cpu = admission.device_bytes(exp, "cpu")
    assert cpu["peak_bytes"] < est["peak_bytes"]
    four = admission.device_bytes(dataclasses.replace(exp, replicas=4),
                                  "cuda")
    assert four["resident_bytes"] == (est["resident_bytes"]
                                      + 3 * est["state_bytes_per_replica"])
    assert four["peak_bytes"] > est["peak_bytes"]


# ---------------------------------------------------------------------- #
# the gate
# ---------------------------------------------------------------------- #
TINY = ROOT / "examples" / "specs" / "tiny_mrls.json"


def _tiny():
    return port_api.Experiment.from_json(TINY.read_text())


def test_admit_off_and_env_modes(monkeypatch):
    exp = _tiny()
    d = port_api.check_admission(exp, device="cpu")
    assert (d.admitted, d.action, d.device) == (True, "admit", "cpu")
    assert d.predicted_bytes == admission.device_peak_bytes(exp, "cpu")
    assert d.budget_bytes == admission.host_ram_bytes()
    assert d.to_dict()["predicted_bytes"] == d.predicted_bytes
    off = port_api.check_admission(exp, device="cpu", mode="off")
    assert (off.admitted, off.action, off.predicted_bytes) == (True, "off",
                                                               0)
    monkeypatch.setenv("REPRO_ADMISSION", "off")
    assert port_api.check_admission(exp, device="cpu").action == "off"
    monkeypatch.setenv("REPRO_ADMISSION", "sometimes")
    with pytest.raises(ValueError, match="auto|warn|off"):
        port_api.check_admission(exp, device="cpu")
    with pytest.raises(ValueError, match="auto|warn|off"):
        port_api.check_admission(exp, device="cpu", mode="never")


def test_refusal_message_and_warn(capsys, monkeypatch):
    exp = _tiny()
    pred = admission.device_peak_bytes(exp, "cpu")
    with pytest.raises(port_api.AdmissionError) as err:
        port_api.check_admission(exp, device="cpu", budget_bytes=pred - 1)
    msg = str(err.value)
    for part in ("'smoke.mrls14'", "on cpu", "table build", "simulator",
                 "1 replica(s)", "(host RAM)", "fewer replicas",
                 "device='cpu'", "REPRO_ADMISSION=warn"):
        assert part in msg, part
    assert port_api.format_bytes(pred) in msg
    assert port_api.check_admission(exp, device="cpu",
                                    budget_bytes=pred).action == "admit"
    d = port_api.check_admission(exp, device="cpu", budget_bytes=pred - 1,
                                 mode="warn")
    assert (d.admitted, d.action, d.reason) == (True, "admit", msg)
    assert capsys.readouterr().out == f"[admission] WARNING: {msg}\n"
    # the environment's warn mode does the same
    monkeypatch.setenv("REPRO_ADMISSION", "warn")
    admission._memo.clear()
    assert port_api.check_admission(exp, device="cpu",
                                    budget_bytes=pred - 1).admitted


def test_decisions_are_memoized(monkeypatch):
    calls = []
    real = admission.device_bytes

    def counted(exp, device=None):
        calls.append(exp)
        return real(exp, device)

    monkeypatch.setattr(admission, "device_bytes", counted)
    exp = _tiny()
    first = port_api.check_admission(exp, device="cpu")
    assert port_api.check_admission(exp, device="cpu") is first
    assert len(calls) == 1
    # a refusal is memoized too, and raised again
    for _ in range(2):
        with pytest.raises(port_api.AdmissionError):
            port_api.check_admission(exp, device="cpu", budget_bytes=1)
    assert len(calls) == 2
    # the seed and the load do not change the price; the replicas do
    port_api.check_admission(exp.override("seed", 9), device="cpu")
    port_api.check_admission(exp.override("workload.load", 0.2),
                             device="cpu")
    assert len(calls) == 2
    port_api.check_admission(exp.override("replicas", 2), device="cpu")
    assert len(calls) == 3


def test_held_bytes_count_as_budget():
    """``run``'s gate adds a simulator the cache holds to the budget it
    passes to ``check_admission``, and nothing else."""
    exp = _tiny()
    held = admission.device_bytes(exp, "cpu")["simulator_bytes"]
    budget = admission.host_ram_bytes()
    cpu = torch.device("cpu")
    with port_api.SimulatorCache() as cache:
        assert runner._admit(exp, cache, cpu).budget_bytes == budget
        cache.get(exp.network, exp.route, cpu)
        assert runner._admit(exp, cache, cpu).budget_bytes == budget + held
        assert runner._admit(exp, None, cpu).budget_bytes == budget


@pytest.fixture
def tiny_budget(monkeypatch):
    """A host with 1 kB of RAM, and a table build that must not run."""
    monkeypatch.setattr(admission, "host_ram_bytes", lambda: 1024)
    built = []

    def no_build(*a, **kw):
        built.append(a)
        raise AssertionError("built before the admission gate")

    monkeypatch.setattr(runner, "_make_simulator", no_build)
    monkeypatch.setattr(runner, "build_tables", no_build)
    return built


def test_run_and_run_all_refuse_before_building(tiny_budget):
    exp = _tiny()
    with pytest.raises(port_api.AdmissionError, match="budget is 1.0 KiB"):
        port_api.run(exp, device="cpu")
    with pytest.raises(port_api.AdmissionError):
        port_api.run_all([exp, exp.override("seed", 1)], device="cpu")
    with pytest.raises(port_api.AdmissionError):
        port_api.sweep(exp, {"workload.load": [0.1, 0.2]}, device="cpu")
    with port_api.SimulatorCache() as cache:
        with pytest.raises(port_api.AdmissionError):
            port_api.run(exp, cache=cache, device="cpu")
        assert len(cache) == 0
    assert not tiny_budget


def test_run_all_prices_a_folded_group_at_its_replicas(monkeypatch):
    """``run_all`` folds consecutive seeds into one batch of that many
    replicas, and prices the batch: a budget that admits one replica
    refuses a three-seed sweep before anything is built."""
    exp = _tiny()
    one = admission.device_peak_bytes(exp, "cpu")
    three = admission.device_peak_bytes(exp.override("replicas", 3), "cpu")
    assert one < three
    monkeypatch.setattr(admission, "host_ram_bytes", lambda: one)
    assert port_api.check_admission(exp, device="cpu").admitted
    built = []

    def no_build(*a, **kw):
        built.append(a)
        raise AssertionError("built before the admission gate")

    monkeypatch.setattr(runner, "_make_simulator", no_build)
    seeds = [exp.override("seed", s) for s in range(3)]
    with pytest.raises(port_api.AdmissionError, match="3 replica"):
        port_api.run_all(seeds, device="cpu")
    with pytest.raises(port_api.AdmissionError, match="3 replica"):
        port_api.sweep(exp, {"seed": [0, 1, 2]}, device="cpu")
    assert not built
    # unfolded, each seed runs alone and is admitted (then built)
    with pytest.raises(AssertionError, match="before the admission gate"):
        port_api.run_all(seeds, fold_seeds=False, device="cpu")


def test_run_resumable_and_resume_refuse_before_building(tiny_budget,
                                                         tmp_path):
    exp = port_api.Experiment.from_json(
        (ROOT / "examples" / "specs" / "tiny_mrls_a2a.json").read_text())
    with pytest.raises(port_api.AdmissionError):
        port_api.run_resumable(exp, str(tmp_path / "a"), device="cpu")
    assert not list((tmp_path / "a").glob("step_*"))
    with pytest.raises(port_api.AdmissionError):
        port_api.resume(str(tmp_path / "a"), device="cpu")
    assert not tiny_budget


def test_off_mode_lets_the_tiny_budget_through(tiny_budget, monkeypatch):
    monkeypatch.setenv("REPRO_ADMISSION", "off")
    with pytest.raises(AssertionError, match="before the admission gate"):
        port_api.run(_tiny(), device="cpu")


def test_a_cached_simulator_counts_as_budget(monkeypatch):
    """With the fabric's simulator in the cache, ``run`` adds its bytes
    to the budget: an experiment priced just over the free budget runs on
    the simulator it already holds."""
    exp = _tiny()
    est = admission.device_bytes(exp, "cpu")
    with port_api.SimulatorCache() as cache:
        first = port_api.run(exp, cache=cache, device="cpu")
        assert cache.holds(exp.network, exp.route, "cpu")
        monkeypatch.setattr(admission, "host_ram_bytes",
                            lambda: est["peak_bytes"]
                            - est["simulator_bytes"])
        assert port_api.run(exp, cache=cache, device="cpu") == first
        with pytest.raises(port_api.AdmissionError):
            port_api.run(exp.override("replicas", 64), cache=cache,
                         device="cpu")


def test_a_run_builds_its_topology_once(monkeypatch):
    """The gate prices the topology that the simulator's build then
    takes: one host build a run."""
    built = []
    real = registry.build_network

    def counted(network):
        built.append(network)
        return real(network)

    monkeypatch.setattr(registry, "build_network", counted)
    monkeypatch.setattr(registry, "_topo_memo", {})
    monkeypatch.setattr(admission, "_dims_memo", {})
    exp = _tiny()
    res = port_api.run(exp, device="cpu")
    assert built == [exp.network]
    assert port_api.run(exp, device="cpu") == res
    assert built == [exp.network]


def test_supervisor_preflight_takes_the_device_peak():
    """A host worker's price is its experiment's ``device_peak_bytes``
    on the CPU, held against the supervisor's RSS budget."""
    exp = _tiny()
    pred = port_api.device_peak_bytes(exp, "cpu")
    argv = [sys.executable, "-c", "pass"]
    with pytest.raises(AdmissionRefused, match=f"predicted peak RSS {pred}"):
        Supervisor(SupervisorConfig(rss_budget_bytes=pred - 1)).run(
            argv, predicted_bytes=pred)
    # at the budget the worker is started (and held to the same RSS
    # budget while it runs)
    started = Supervisor(SupervisorConfig(rss_budget_bytes=pred,
                                          max_retries=0,
                                          poll_interval_s=0.05)).run(
        argv, predicted_bytes=pred)
    assert len(started.attempts) == 1


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("spec,replicas", [("tiny_mrls.json", None),
                                           ("headline_a2a.json", None),
                                           ("tiny_workloads.json", 3)])
def test_cli_estimate_equals_the_reference(tmp_path, capsys, spec,
                                           replicas):
    path = str(ROOT / "examples" / "specs" / spec)
    extra = [] if replicas is None else ["--replicas", str(replicas)]
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    assert jax_cli_main(["estimate", path, "--out", str(ref_out)]
                        + extra) == 0
    capsys.readouterr()
    assert cli_main(["estimate", path, "--device", "cpu", "--out",
                     str(port_out)] + extra) == 0
    out = capsys.readouterr().out
    ref = json.loads(ref_out.read_text())
    got = json.loads(port_out.read_text())
    assert len(got) == len(ref) >= 1
    budget = admission.host_ram_bytes()
    for g, r in zip(got, ref):
        assert g.pop("budget_bytes") == budget
        assert g.pop("predicted_device_bytes") > 0
        del r["compile_ram_multiplier"], r["predicted_peak_rss_bytes"]
        assert g == r
    lines = out.splitlines()
    assert lines[-2].startswith("device cpu: budget ")
    assert lines[-1] == f"wrote {len(got)} estimate(s) to {port_out}"
    assert all("predicted_device=" in line and "(cpu)" in line
               for line in lines[:len(got)])
