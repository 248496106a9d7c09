"""The JAX reference Results of the port's Figure-7 points.

The paper's Figure 7 compares the Dragonfly ``dragonfly(16, 8, 8)``
(16,512 endpoints) and the Dragonfly+ ``dragonfly_plus(65, 16, 16, 16,
16)`` (16,640) under UGAL with the MRLS ``mrls(1280, 19, 13, seed=1)``
(16,640) under Polarized (``benchmarks/fig7_dragonfly.py --full``).
``chip_smoke.py`` runs these points through ``repro_torch`` on the card,
one replica each (the benchmark runs 4), and holds each Result to its
committed JSON field for field:

* ``fig7.df.ugal.all2all``, ``fig7.dfplus.ugal.all2all`` and
  ``fig7.mrls_u19.pol.all2all`` -- All2All of 16 rounds to completion;
* ``fig7.df.ugal.thpt.uniform`` -- uniform load 1.0, 100 + 100 slots
  (cut from the figure's 300 + 300 to keep ``chip_smoke.py`` inside its
  time limit);
* ``fig7.df.ugal.thpt.{rep,rsp,bu}`` -- load 1.0, 50 + 50 slots (the
  same cut);
* ``fig7.df.ugal.lat.mice_elephant`` -- load 0.5, latency metric,
  50 + 50 slots (the same cut).

Here the MRLS All2All is re-run through the reference package and must
still equal its file; for the others the test checks that they record
the experiments above.

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_fig7_reference.py --capture`` (a few minutes on a CPU
host, with jax's partitionable threefry stream).
"""
import json
import pathlib
import sys

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

DF = {"family": "dragonfly", "params": {"a": 16, "p": 8, "h": 8}}
DF_PLUS = {"family": "dragonfly_plus",
           "params": {"n_groups": 65, "leaves_per_group": 16,
                      "spines_per_group": 16, "p": 16,
                      "global_per_spine": 16}}
MRLS_U19 = {"family": "mrls",
            "params": {"n_leaves": 1280, "u": 19, "d": 13, "seed": 1}}
UGAL = {"policy": "ugal", "vcs": 4, "max_hops": 6}
POLARIZED = {"policy": "polarized", "vcs": 4, "max_hops": 8}


def _all2all(name, network, route):
    return {"network": network, "route": route,
            "workload": {"pattern": "all2all", "rounds": 16},
            "name": name, "max_slots": 60_000}


def _bernoulli(name, pattern, load, window, metric="auto"):
    return {"network": DF, "route": UGAL,
            "workload": {"pattern": pattern, "load": load},
            "name": name, "metric": metric, "warm": window,
            "measure": window}


POINTS = {
    "torch_fig7_df_ugal_a2a.json": _all2all("fig7.df.ugal.all2all", DF, UGAL),
    "torch_fig7_dfplus_ugal_a2a.json": _all2all("fig7.dfplus.ugal.all2all",
                                                DF_PLUS, UGAL),
    "torch_fig7_mrls_u19_pol_a2a.json": _all2all("fig7.mrls_u19.pol.all2all",
                                                 MRLS_U19, POLARIZED),
    "torch_fig7_df_ugal_thpt_uniform.json": _bernoulli(
        "fig7.df.ugal.thpt.uniform", "uniform", 1.0, 100),
    **{f"torch_fig7_df_ugal_thpt_{p}.json": _bernoulli(
        f"fig7.df.ugal.thpt.{p}", p, 1.0, 50) for p in ("rep", "rsp", "bu")},
    "torch_fig7_df_ugal_lat_mice_elephant.json": _bernoulli(
        "fig7.df.ugal.lat.mice_elephant", "mice_elephant", 0.5, 50,
        metric="latency"),
}
RERUN = "torch_fig7_mrls_u19_pol_a2a.json"


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


def test_committed_mrls_u19_all2all_reference_matches_jax():
    assert json.loads((GOLDEN_DIR / RERUN).read_text()) == \
        reference_result(RERUN)


@pytest.mark.parametrize("fname", sorted(POINTS))
def test_committed_fig7_references_record_the_paper_points(fname):
    golden = json.loads((GOLDEN_DIR / fname).read_text())
    exp = _experiment(fname)
    assert golden["experiment"] == exp.to_dict()
    assert golden["metric"] == exp.resolved_metric()
    if golden["metric"] == "completion":
        assert golden["completed"] is True
        assert isinstance(golden["slots"], int) and golden["slots"] > 0
    elif golden["metric"] == "throughput":
        assert 0 < golden["throughput"] <= 1
        assert golden["ejected"] > 0
    else:
        assert set(golden["latency"]) == {"p50", "p99", "p999", "p9999"}
        assert all(v >= 1 for v in golden["latency"].values())


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_fig7_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or tuple(POINTS))
