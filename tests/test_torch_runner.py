"""The port's shared-simulator runner against the reference's.

* ``SimulatorCache`` builds one simulator per (network, route, device)
  and hands the same one back; ``run(..., cache=)`` takes it from there.
* ``run_all`` equals a loop of ``run`` and the reference's ``run_all``
  Result for Result, on two fabrics, three patterns and a seed axis that
  the reference folds into one batched run (the port runs it seed by
  seed); with a private cache it drops each fabric's simulator after
  its last experiment, and it refuses an unported experiment before it
  builds anything.
* ``expand_axes`` and ``sweep`` equal the reference's.
* The CLI subcommands ``sweep``, ``families`` and ``patterns`` with
  ``--device cpu``.

Tolerance: zero.
"""
import json

import pytest
import torch

import repro.api as jax_api
import repro_torch.api as port_api
from repro_torch.api import runner
from repro_torch.api.__main__ import main as cli_main

MRLS = {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3,
                                     "seed": 0}}
OFT = {"family": "oft", "params": {"q": 3}}
ROUTE = {"policy": "polarized", "max_hops": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(api, network=MRLS, route=ROUTE, **kw):
    d = {"network": network, "route": route, "warm": 10, "measure": 20}
    d.update(kw)
    return api.Experiment.from_dict(d)


def _suite(api):
    """Two fabrics; on the MRLS three patterns and a seed-only stretch
    (seeds 1, 2, 3) that the reference's run_all folds."""
    out = [_exp(api, workload={"pattern": "uniform", "load": 0.6},
                seed=s, name=f"uniform.s{s}") for s in (1, 2, 3)]
    out += [_exp(api, workload={"pattern": "tornado", "load": 0.5}),
            _exp(api, workload={"pattern": "all2all", "rounds": 3}),
            _exp(api, network=OFT, workload={"pattern": "bursty",
                                             "load": 0.5}),
            _exp(api, network=OFT, metric="latency",
                 workload={"pattern": "hotspot", "load": 0.6})]
    return out


@pytest.fixture(scope="module")
def reference_results():
    return [r.to_dict() for r in jax_api.run_all(_suite(jax_api))]


def _count_builds(monkeypatch):
    built = []
    make = runner._make_simulator

    def counted(network, route, device):
        built.append((network, route, device))
        return make(network, route, device)
    monkeypatch.setattr(runner, "_make_simulator", counted)
    return built


def test_cache_builds_one_simulator_per_fabric_and_route(monkeypatch):
    built = _count_builds(monkeypatch)
    pol = port_api.RouteSpec.from_dict(ROUTE)
    ksp = port_api.RouteSpec(policy="ksp", max_hops=8)
    mrls = port_api.NetworkSpec.from_dict(MRLS)
    with port_api.SimulatorCache() as cache:
        sim = cache.get(mrls, pol, "cpu")
        assert cache.get(mrls, pol, "cpu") is sim
        assert cache.get(port_api.NetworkSpec.from_dict(MRLS),
                         port_api.RouteSpec.from_dict(ROUTE), "cpu") is sim
        assert cache.get(mrls, ksp, "cpu") is not sim
        assert len(cache) == 2 and len(built) == 2
        res = [port_api.run(e, cache=cache, device="cpu")
               for e in _suite(port_api)[:5]]
        assert len(cache) == 2 and len(built) == 2
        assert all(r.experiment.network == mrls for r in res)
        cache.release(mrls, ksp, "cpu")
        cache.release(mrls, ksp, "cpu")             # absent: a no-op
        assert len(cache) == 1
    assert len(cache) == 0
    with port_api.open_simulator(mrls, pol, device="cpu") as sim:
        assert sim.S == 42 and sim.device.type == "cpu"


def test_run_all_equals_reference_and_a_loop_of_run(monkeypatch,
                                                    reference_results):
    built = _count_builds(monkeypatch)
    got = [r.to_dict() for r in port_api.run_all(_suite(port_api),
                                                 device="cpu")]
    assert got == reference_results
    assert len(built) == 2                          # one per fabric
    loop = [port_api.run(e, device="cpu").to_dict()
            for e in _suite(port_api)]
    assert loop == reference_results
    assert [r["experiment"]["seed"] for r in got[:3]] == [1, 2, 3]
    assert got[0] != got[1]


def test_run_all_shares_a_given_cache_and_drops_its_own(monkeypatch):
    released = []
    release = port_api.SimulatorCache.release

    def spy(self, network, route, device=None):
        released.append(network.family)
        return release(self, network, route, device)
    monkeypatch.setattr(port_api.SimulatorCache, "release", spy)
    exps = _suite(port_api)
    port_api.run_all(exps, device="cpu", fold_seeds=False)
    assert released == ["mrls", "oft"]              # after each last use
    released.clear()
    with port_api.SimulatorCache() as cache:
        port_api.run_all(exps[:2], cache=cache, device="cpu")
        assert released == [] and len(cache) == 1   # the caller's to keep


def test_run_all_refuses_before_building(monkeypatch):
    built = _count_builds(monkeypatch)
    # an allreduce runs now; replicas are still to come
    exps = [_exp(port_api), _exp(port_api, workload={"pattern": "allreduce"}),
            _exp(port_api, replicas=2)]
    with pytest.raises(NotImplementedError, match="replicated"):
        port_api.run_all(exps, device="cpu")
    assert built == []


AXES = {"workload.load": [0.3, 0.6], "route.policy": ["polarized", "ksp"],
        "seed": [0, 5], "network.params.seed": [0, 1]}


def test_expand_axes_equals_reference():
    got = port_api.expand_axes(_exp(port_api, name="grid"), AXES)
    want = jax_api.expand_axes(_exp(jax_api, name="grid"), AXES)
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    assert len(got) == 16 and got[0].name.startswith("grid[")
    assert port_api.expand_axes(_exp(port_api), {}) == [_exp(port_api)]


def test_sweep_equals_reference():
    axes = {"workload.load": [0.4, 0.8], "seed": [0, 2]}
    got = port_api.sweep(_exp(port_api), axes, device="cpu")
    want = jax_api.sweep(_exp(jax_api), axes)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]


def test_cli_sweep_families_and_patterns(tmp_path, capsys):
    spec = tmp_path / "sweep.json"
    spec.write_text(json.dumps({
        "base": {"network": MRLS, "route": ROUTE, "warm": 10, "measure": 20,
                 "workload": {"pattern": "shift", "load": 0.5, "shift": 3},
                 "name": "cli"},
        "axes": {"workload.load": [0.5, 0.7]}}))
    out = tmp_path / "results.json"
    assert cli_main(["sweep", str(spec), "--device", "cpu", "--seed", "4",
                     "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cli[workload.load=0.5]  metric=throughput")
    assert lines[-1] == f"wrote 2 result(s) to {out}"
    records = json.loads(out.read_text())
    assert [r["experiment"]["seed"] for r in records] == [4, 4]
    base = jax_api.Experiment.from_dict(json.loads(spec.read_text())["base"])
    want = jax_api.sweep(base.override("seed", 4), {"workload.load": [0.5,
                                                                      0.7]})
    assert records == [r.to_dict() for r in want]

    assert cli_main(["families", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split() == list(
        port_api.topology_families())
    assert cli_main(["patterns", "--device", "cpu"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert "tornado  [bernoulli]" in listed
    assert "all2all  [collective]" in listed
    for name in ("allreduce", "ring_allreduce", "rd_allreduce"):
        assert f"{name}  [collective]" in listed
    assert "poisson  [arrival]  (not ported yet)" in listed
    assert not any(line.startswith(("phase", "program")) for line in listed)
