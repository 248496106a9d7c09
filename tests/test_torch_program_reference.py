"""The port's workload programs held to the JAX reference's Results.

* Every experiment of ``examples/specs/tiny_workloads.json`` (three
  adversarial families, a ring allreduce, a windowed all2all and a
  windowed allreduce) through ``repro_torch.api.run_all(device="cpu")``
  and through the CLI's ``run`` equals ``repro.api.run_all``'s records.
* A barrier Rabenseifner allreduce on the golden ``mrls(14, 3, 3)``
  under each of the five ported policies equals ``repro.api.run``'s
  Result, ``phase_slots`` included.
* The four workload-program points that ``chip_smoke.py`` phase 14 runs
  on the card, one replica each (the figures run 4), and holds field for
  field to the reference's Results committed here as
  ``tests/golden/torch_prog_*.json``:

  - ``fig5.mrls_u18.pol.allreduce`` -- ``mrls(614, 18, 18, seed=1)``
    (11,052 endpoints) under Polarized with ``max_hops`` 6, Rabenseifner
    over 8,192 ranks of 16 packets (26 phases, 48 packets a rank),
    ``max_slots`` 30,000: ``benchmarks/fig5_11k.py --full``'s allreduce
    row (``benchmarks/bench_sim.py``);
  - ``fig5.oft_q17.pol.allreduce`` -- ``oft(17)`` with the same workload
    and route;
  - ``fig7.df.ugal.allreduce`` -- ``dragonfly(16, 8, 8)`` (16,512
    endpoints) under UGAL with ``max_hops`` 6 over 16,384 ranks (28
    phases): ``benchmarks/fig7_dragonfly.py --full``'s row;
  - ``fig5.mrls_u18.pol.a2a_window`` -- the Figure-5 MRLS running the
    figure's 24 All2All rounds as a pipelined program
    (``schedule="window"``, ``window=4``).

  Here the test checks that each file records its experiment and a
  complete run; the full-size runs take minutes on a CPU.

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_program_reference.py --capture [file ...]`` (jax's
partitionable threefry stream).  Tolerance: zero.
"""
import json
import pathlib
import sys

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_WORKLOADS = ROOT / "examples" / "specs" / "tiny_workloads.json"

MRLS_U18 = {"family": "mrls",
            "params": {"n_leaves": 614, "u": 18, "d": 18, "seed": 1}}
OFT = {"family": "oft", "params": {"q": 17}}
DF = {"family": "dragonfly", "params": {"a": 16, "p": 8, "h": 8}}
POLARIZED = {"policy": "polarized", "vcs": 4, "max_hops": 6}
UGAL = {"policy": "ugal", "vcs": 4, "max_hops": 6}


def _allreduce(name, network, route, ranks):
    return {"network": network, "route": route,
            "workload": {"pattern": "allreduce", "ranks": ranks,
                         "vec_packets": 16},
            "name": name, "max_slots": 30_000}


POINTS = {
    "torch_prog_fig5_mrls_allreduce.json": _allreduce(
        "fig5.mrls_u18.pol.allreduce", MRLS_U18, POLARIZED, 8192),
    "torch_prog_fig5_oft_allreduce.json": _allreduce(
        "fig5.oft_q17.pol.allreduce", OFT, POLARIZED, 8192),
    "torch_prog_fig7_df_allreduce.json": _allreduce(
        "fig7.df.ugal.allreduce", DF, UGAL, 16384),
    "torch_prog_fig5_mrls_a2a_window.json": {
        "network": MRLS_U18, "route": POLARIZED,
        "workload": {"pattern": "all2all", "rounds": 24,
                     "schedule": "window", "window": 4},
        "name": "fig5.mrls_u18.pol.a2a_window", "max_slots": 60_000},
}
# phases of each point: 2 log2(ranks) for Rabenseifner, the rounds for
# the windowed all2all
N_PHASES = {"torch_prog_fig5_mrls_allreduce.json": 26,
            "torch_prog_fig5_oft_allreduce.json": 26,
            "torch_prog_fig7_df_allreduce.json": 28,
            "torch_prog_fig5_mrls_a2a_window.json": 24}

TINY = {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3,
                                     "seed": 0}}
POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant")


def _experiment(fname):
    from repro.api import Experiment
    return Experiment.from_dict(POINTS[fname])


def reference_result(fname) -> dict:
    """The reference package's Result of one point, as a dict."""
    from repro.api import run
    return run(_experiment(fname)).to_dict()


def capture(names=tuple(POINTS)) -> None:
    """Write the reference Results of ``names`` into ``tests/golden``."""
    for fname in names:
        path = GOLDEN_DIR / fname
        path.write_text(json.dumps(reference_result(fname), indent=1,
                                   sort_keys=True) + "\n")
        print(f"wrote {path}", flush=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fname", sorted(POINTS))
def test_committed_program_references_record_the_points(fname):
    golden = json.loads((GOLDEN_DIR / fname).read_text())
    exp = _experiment(fname)
    assert golden["experiment"] == exp.to_dict()
    assert golden["metric"] == "completion" == exp.resolved_metric()
    assert golden["completed"] is True
    phases = golden["phase_slots"]
    assert len(phases) == N_PHASES[fname]
    assert all(isinstance(s, int) and s > 0 for s in phases)
    if exp.workload.schedule == "window":
        # cumulative completion slots, the last one the run's
        assert phases == sorted(phases) and golden["slots"] == phases[-1]
    else:
        assert golden["slots"] == sum(phases)


@pytest.fixture(scope="module")
def tiny_workload_records():
    """The reference's records of ``tiny_workloads.json``."""
    import repro.api as jax_api
    docs = json.loads(TINY_WORKLOADS.read_text())["experiments"]
    return [r.to_dict() for r in jax_api.run_all(
        [jax_api.Experiment.from_dict(d) for d in docs])]


def test_tiny_workloads_run_all_equals_reference(tiny_workload_records):
    import repro_torch.api as port_api
    docs = json.loads(TINY_WORKLOADS.read_text())["experiments"]
    got = port_api.run_all([port_api.Experiment.from_dict(d) for d in docs],
                           device="cpu")
    assert [r.to_dict() for r in got] == tiny_workload_records
    assert [r.phase_slots is not None for r in got] == [
        False, False, False, True, True, True]


def test_cli_run_of_tiny_workloads_prints_the_reference_records(
        tiny_workload_records, capsys, tmp_path):
    from repro_torch.api.__main__ import main as cli_main
    out = tmp_path / "records.json"
    assert cli_main(["run", str(TINY_WORKLOADS), "--device", "cpu",
                     "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == printed
    assert printed == tiny_workload_records


@pytest.mark.parametrize("policy", POLICIES)
def test_barrier_rabenseifner_equals_reference_under_each_policy(policy):
    """``max_slots`` 40 is five times what a phase takes here, except
    under ``valiant``, whose packets strand when their intermediate leaf
    is their source leaf (a reference behaviour, ROADMAP section 3): each
    of its phases is forced across at slot 48, the first chunk boundary
    past the budget, and the port must do the same."""
    import repro.api as jax_api
    import repro_torch.api as port_api
    d = {"network": TINY,
         "route": {"policy": policy, "max_hops": 10, "pool": 4096},
         "workload": {"pattern": "allreduce", "ranks": 16,
                      "vec_packets": 8},
         "seed": 2, "max_slots": 40}
    want = jax_api.run(jax_api.Experiment.from_dict(d))
    got = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    assert got.to_dict() == want.to_dict()
    assert len(got.phase_slots) == 8
    if policy == "valiant":
        assert not got.completed and set(got.phase_slots) == {48}
    else:
        assert got.completed and max(got.phase_slots) < 40


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_program_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or tuple(POINTS))
