"""The JAX reference Results of the port's Figure-5 OFT row and of the
adversarial Bernoulli families at the Figure-5 size.

Figure 5 (``benchmarks/fig5_11k.py --full``) puts the Orthogonal
Fat-Tree ``oft(17)`` (N 921, 614 leaves, 11,052 endpoints, P 36) under
Polarized with ``max_hops`` 6 next to the cost-matched MRLS.
``chip_smoke.py`` runs these points through ``repro_torch`` on the card,
one replica each (the benchmark runs 4), through one ``run_all`` a
fabric with one ``SimulatorCache``, and holds each Result to its
committed JSON field for field:

* ``fig5.oft_q17.pol.all2all`` -- All2All of the figure's 24 rounds;
* ``fig5.oft_q17.pol.thpt.uniform`` -- uniform load 1.0, 100 + 100
  slots (cut from the figure's 300 + 300 to keep ``chip_smoke.py`` inside
  its time limit);
* ``fig5.oft_q17.pol.thpt.{rep,rsp,bu}`` -- load 1.0, 50 + 50 slots (the
  same cut);
* ``fig5.oft_q17.pol.lat.mice_elephant`` -- load 0.5, latency metric,
  50 + 50 slots (the same cut);
* ``fig5.mrls_u18.pol.thpt.{tornado,shift,hotspot,bursty}`` -- the
  adversarial families on the Figure-5 MRLS ``mrls(614, 18, 18,
  seed=1)``, 50 + 50 slots (the same cut): tornado at load 0.5 (the load of
  ``benchmarks/bench_faults.py``), shift at 1.0 with ``shift`` 18 (one
  leaf's worth of endpoints, so every message leaves its leaf), hotspot
  at 0.7 (``hot_frac`` 0.1 onto one endpoint), bursty at 0.5
  (``burst_load`` 1.0, ``burst_len`` 8).

Here the OFT All2All is re-run through the reference package and must
still equal its file; for the others the test checks that they record
the experiments above.

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_fig5_oft_reference.py --capture [file ...]`` (about 10
minutes on a CPU host, with jax's partitionable threefry stream).
"""
import json
import pathlib
import sys

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

OFT = {"family": "oft", "params": {"q": 17}}
MRLS_U18 = {"family": "mrls",
            "params": {"n_leaves": 614, "u": 18, "d": 18, "seed": 1}}
POLARIZED = {"policy": "polarized", "vcs": 4, "max_hops": 6}


def _bernoulli(name, network, workload, window, metric="auto"):
    return {"network": network, "route": POLARIZED, "workload": workload,
            "name": name, "metric": metric, "warm": window,
            "measure": window}


FIG5_OFT = {
    "torch_fig5_oft_a2a.json": {
        "network": OFT, "route": POLARIZED,
        "workload": {"pattern": "all2all", "rounds": 24},
        "name": "fig5.oft_q17.pol.all2all", "max_slots": 60_000},
    "torch_fig5_oft_thpt_uniform.json": _bernoulli(
        "fig5.oft_q17.pol.thpt.uniform", OFT,
        {"pattern": "uniform", "load": 1.0}, 100),
    **{f"torch_fig5_oft_thpt_{p}.json": _bernoulli(
        f"fig5.oft_q17.pol.thpt.{p}", OFT, {"pattern": p, "load": 1.0}, 50)
       for p in ("rep", "rsp", "bu")},
    "torch_fig5_oft_lat_mice_elephant.json": _bernoulli(
        "fig5.oft_q17.pol.lat.mice_elephant", OFT,
        {"pattern": "mice_elephant", "load": 0.5}, 50, metric="latency"),
}
ADVERSARIAL = {
    f"torch_adv_{w['pattern']}.json": _bernoulli(
        f"fig5.mrls_u18.pol.thpt.{w['pattern']}", MRLS_U18, w, 50)
    for w in ({"pattern": "tornado", "load": 0.5},
              {"pattern": "shift", "load": 1.0, "shift": 18},
              {"pattern": "hotspot", "load": 0.7, "hot_frac": 0.1,
               "hot_count": 1},
              {"pattern": "bursty", "load": 0.5, "burst_load": 1.0,
               "burst_len": 8.0})}
POINTS = {**FIG5_OFT, **ADVERSARIAL}
RERUN = "torch_fig5_oft_a2a.json"


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


def test_committed_oft_all2all_reference_matches_jax():
    assert json.loads((GOLDEN_DIR / RERUN).read_text()) == \
        reference_result(RERUN)


@pytest.mark.parametrize("fname", sorted(POINTS))
def test_committed_references_record_the_points(fname):
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
                 "tests/test_torch_fig5_oft_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or tuple(POINTS))
