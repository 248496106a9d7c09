"""The port's spec layer and runner against the reference's.

Spec files load into equal dicts in both packages, and
``repro_torch.api.run`` on ``examples/specs/tiny_mrls.json`` returns a
Result equal field for field to ``repro.api.run``'s.
"""
import json
import pathlib

import pytest
import torch

import repro.api as jax_api
import repro_torch.api as port_api
from repro_torch.api.__main__ import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name):
    return json.loads((SPECS / name).read_text())


@pytest.mark.parametrize("name", ["tiny_mrls.json", "fig5_mrls_u6.json"])
def test_spec_dicts_match_reference(name):
    d = _spec(name)
    port = port_api.Experiment.from_dict(d)
    ref = jax_api.Experiment.from_dict(d)
    assert port.to_dict() == ref.to_dict()
    assert port.resolved_metric() == ref.resolved_metric()
    assert port.label() == ref.label()
    assert port_api.Experiment.from_json(port.to_json()) == port


def test_run_matches_reference_on_tiny_mrls():
    d = _spec("tiny_mrls.json")
    ref = jax_api.run(jax_api.Experiment.from_dict(d))
    got = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    assert got.metric == "throughput"
    assert got.to_dict() == ref.to_dict()


def test_latency_metric_runs_on_the_port():
    d = dict(_spec("tiny_mrls.json"), metric="latency", warm=10, measure=20)
    res = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    assert set(res.latency) == {"p50", "p99", "p999", "p9999"}
    assert all(v is None or v >= 1.0 for v in res.latency.values())
    assert res.throughput is None


def test_cli_run_writes_the_result(tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(_spec("tiny_mrls.json"), warm=5,
                                    measure=10)))
    out = tmp_path / "result.json"
    assert cli_main(["run", str(spec), "--device", "cpu",
                     "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == printed
    assert printed["metric"] == "throughput" and printed["ejected"] > 0


def test_unported_specs_raise():
    d = _spec("tiny_mrls.json")
    # workload programs run, but only to completion (the reference's
    # ValueError), and the serving metric is still to come
    for workload, metric in (({"pattern": "all2all", "rounds": 2,
                               "schedule": "barrier"}, "throughput"),
                             ({"pattern": "allreduce"}, "serving")):
        with pytest.raises(ValueError, match="only supports the completion"):
            port_api.run(port_api.Experiment.from_dict(
                dict(d, workload=workload, metric=metric)), device="cpu")
    with pytest.raises(NotImplementedError, match="serving"):
        port_api.run(port_api.Experiment.from_dict(
            dict(d, metric="serving")), device="cpu")
    with pytest.raises(NotImplementedError, match="serving"):
        port_api.run(port_api.Experiment.from_dict(
            dict(d, workload={"pattern": "poisson", "load": 0.5})),
            device="cpu")
    with pytest.raises(ValueError, match="collective"):
        port_api.run(port_api.Experiment.from_dict(
            dict(d, metric="completion")), device="cpu")
    with pytest.raises(NotImplementedError, match="replicated"):
        port_api.run(port_api.Experiment.from_dict(dict(d, replicas=2)),
                     device="cpu")
    with pytest.raises(KeyError, match="unknown topology family"):
        port_api.build_network(port_api.NetworkSpec("torus", {"k": 4}))
    with pytest.raises(NotImplementedError, match="prime q"):
        port_api.build_network(port_api.NetworkSpec("oft", {"q": 4}))
    failing = dict(d["network"], failures={"events": []})
    with pytest.raises(NotImplementedError, match="failure"):
        port_api.Experiment.from_dict(dict(d, network=failing))
