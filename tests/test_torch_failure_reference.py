"""The JAX reference's failure-injection records that ``chip_smoke.py``
holds the port to on the card (phase 17).

Four points, each at ``benchmarks/bench_faults.py``'s settings (uniform
load 0.5, ``fail_seed`` 0) with the depth cut for time:

* ``torch_fault_mrls1k_sweep.json`` -- ``degrade_sweep`` on the 1k MRLS
  ``mrls(56, 18, 18, seed=1)`` (1,008 endpoints) under
  ``RouteSpec(policy="degraded", max_hops=12)``: ``random_links`` at
  rates 0, 0.05 and 0.10 of the 1,008 links, down at slot 10, requeue,
  warm 50 / measure 150 a rate (the bench runs five rates at 200 + 400);
  the file holds the ``DegradeSpec`` and the degradation record;
* ``torch_fault_fig5_mrls_drop.json`` -- the Figure-5 MRLS
  ``mrls(614, 18, 18, seed=1)`` (11,052 endpoints) under
  ``fig5_11k.py --full``'s Polarized route (``max_hops`` 6): 1 % of its
  links (``round(0.01 * n_links)``, ``random_links``) down at slot 20
  and back at 60, ``drop``, warm 40 / measure 60, through ``run``;
* ``torch_fault_ft1k_switch.json`` -- ``fat_tree(16, 2)`` (1,024
  endpoints), degraded: the lowest-indexed non-leaf switch down at slot
  10 and back at 40, requeue, warm 20 / measure 40;
* ``torch_fault_df1k_ugal.json`` -- ``dragonfly(a=8, p=4, h=4)`` (1,056
  endpoints) under ugal: ``random_ladder(count=8, start_slot=10,
  step_slots=8)``, requeue, warm 30 / measure 60, so that links go down
  in warm-up and in the measured window.

Each Result is a ``resilience`` Result whose experiment carries its
schedule.  The runs take minutes on a CPU, so the tests check that each
file records its point and replay the two short 1k points (the
Fat-Tree's switch event and the Dragonfly's ladder) through the port on
the CPU; the engine's failure branch is held state for state to the
live reference on small fabrics in ``tests/test_torch_failures.py``.

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_failure_reference.py --capture [file ...]`` (jax's
partitionable threefry stream).  Tolerance: zero.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

SWEEP = "torch_fault_mrls1k_sweep.json"
FIG5 = "torch_fault_fig5_mrls_drop.json"
FT_SWITCH = "torch_fault_ft1k_switch.json"
DF_UGAL = "torch_fault_df1k_ugal.json"
FILES = (SWEEP, FIG5, FT_SWITCH, DF_UGAL)

MRLS1K = {"family": "mrls",
          "params": {"n_leaves": 56, "u": 18, "d": 18, "seed": 1}}
FIG5_MRLS = {"family": "mrls",
             "params": {"n_leaves": 614, "u": 18, "d": 18, "seed": 1}}
FT1K = {"family": "fat_tree", "params": {"radix": 16, "h": 2}}
DF1K = {"family": "dragonfly", "params": {"a": 8, "p": 4, "h": 4}}
DEGRADED = {"policy": "degraded", "max_hops": 12}
UNIFORM = {"pattern": "uniform", "load": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep_spec() -> dict:
    """The degradation sweep of the 1k MRLS, cut to three rates and 200
    slots a rate."""
    return {"base": {"network": MRLS1K, "route": DEGRADED,
                     "workload": UNIFORM, "name": "faults.mrls1k.uniform0.5",
                     "seed": 0, "warm": 50, "measure": 150},
            "rates": [0.0, 0.05, 0.10], "down_slot": 10,
            "fail_policy": "requeue", "fail_seed": 0}


def experiment_points(core) -> dict:
    """The three ``run`` points as experiment dicts, by golden file; the
    schedules drawn by ``core`` (either package's, they are the same
    numpy code) on its topologies."""
    fig5 = core.mrls(**FIG5_MRLS["params"])
    k = round(0.01 * len(core.canonical_link_ids(fig5)))
    fig5_sched = core.FailureSchedule.random_links(
        fig5, k, down_slot=20, up_slot=60, seed=0, policy="drop")
    ft = core.fat_tree(**FT1K["params"])
    spine = int(np.nonzero(~ft.is_leaf)[0][0])
    ft_sched = core.FailureSchedule(
        (core.FailureEvent("switch", spine, 10, 40),), policy="requeue")
    df = core.dragonfly(**DF1K["params"])
    df_sched = core.FailureSchedule.random_ladder(
        df, 8, start_slot=10, step_slots=8, seed=0, policy="requeue")
    route5 = {"policy": "polarized", "max_hops": 6}
    return {
        FIG5: {"network": dict(FIG5_MRLS, failures=fig5_sched.to_dict()),
               "route": route5, "workload": UNIFORM,
               "name": "faults.fig5_mrls.drop", "warm": 40, "measure": 60},
        FT_SWITCH: {"network": dict(FT1K, failures=ft_sched.to_dict()),
                    "route": DEGRADED, "workload": UNIFORM,
                    "name": "faults.ft1k.switch", "warm": 20, "measure": 40},
        DF_UGAL: {"network": dict(DF1K, failures=df_sched.to_dict()),
                  "route": {"policy": "ugal", "max_hops": 12},
                  "workload": UNIFORM, "name": "faults.df1k.ugal_ladder",
                  "warm": 30, "measure": 60},
    }


def reference_record(fname):
    """The reference package's record of one golden file."""
    import repro.core as core
    from repro.api import DegradeSpec, Experiment, degrade_sweep, run
    if fname == SWEEP:
        spec = DegradeSpec.from_dict(sweep_spec())
        return {"spec": spec.to_dict(), "record": degrade_sweep(spec)}
    return run(Experiment.from_dict(experiment_points(core)[fname])
               ).to_dict()


def capture(names=FILES) -> None:
    """Write the reference records of ``names`` into ``tests/golden``."""
    for fname in names:
        path = GOLDEN_DIR / fname
        path.write_text(json.dumps(reference_record(fname), indent=1,
                                   sort_keys=True) + "\n")
        print(f"wrote {path}", flush=True)


def _load(fname):
    return json.loads((GOLDEN_DIR / fname).read_text())


LATENCY = ("p50", "p99", "p999", "p9999")


def test_sweep_golden_records_the_spec():
    import repro_torch.api as port_api
    g = _load(SWEEP)
    spec = port_api.DegradeSpec.from_dict(sweep_spec())
    assert g["spec"] == spec.to_dict()
    rec = g["record"]
    assert rec["name"] == spec.base.label() == "faults.mrls1k.uniform0.5"
    assert rec["base"] == spec.base.to_dict()
    assert (rec["policy"], rec["fail_policy"], rec["down_slot"],
            rec["fail_seed"], rec["n_links"]) == ("degraded", "requeue", 10,
                                                  0, 1008)
    assert [p["rate"] for p in rec["points"]] == [0.0, 0.05, 0.10]
    assert [p["n_links_down"] for p in rec["points"]] == [0, 50, 101]
    for p in rec["points"]:
        assert sorted(p) == sorted(("rate", "n_links_down", "delivered",
                                    "avg_hops", "fail_drop", "p50", "p99",
                                    "retention"))
        assert 0 < p["delivered"] and p["p99"] is not None
    assert rec["points"][0]["retention"] == 1.0


@pytest.mark.parametrize("fname", (FIG5, FT_SWITCH, DF_UGAL))
def test_fault_golden_records_its_point(fname):
    import repro_torch.api as port_api
    import repro_torch.core as port_core
    rec = _load(fname)
    exp = port_api.Experiment.from_dict(experiment_points(port_core)[fname])
    assert rec["experiment"] == exp.to_dict()
    assert rec["metric"] == "resilience" == exp.resolved_metric()
    assert port_api.Result.from_dict(rec).to_dict() == rec
    assert rec["throughput"] > 0 and rec["per_replica"] is None
    assert all(rec["latency"][k] is not None for k in LATENCY)
    sched = exp.network.failures
    assert sched.validate(port_api.build_network(exp.network)) is sched
    if fname == FIG5:
        assert (len(sched), sched.policy) == (111, "drop")


def test_schedules_are_drawn_as_the_reference_draws_them():
    import repro.core as jax_core
    import repro_torch.core as port_core
    assert experiment_points(port_core) == experiment_points(jax_core)


@pytest.mark.parametrize("fname", (FT_SWITCH, DF_UGAL))
def test_short_fault_goldens_through_the_port(fname):
    """The Fat-Tree's switch event (every leaf row rebuilt, the switch's
    column UNREACHABLE) and the Dragonfly's UGAL ladder (transitions in
    warm-up and in the window) replayed through ``repro_torch.api.run``
    on the CPU."""
    import repro_torch.api as port_api
    rec = _load(fname)
    got = port_api.run(port_api.Experiment.from_dict(rec["experiment"]),
                       device="cpu")
    assert got.to_dict() == rec


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_failure_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture") or FILES)
