"""The JAX reference Results of the port's All2All points.

The paper's Figure 6 compares a 50 %-depopulated Fat-Tree with an MRLS
of the same 104,976 endpoints under an All2All of 16 rounds
(``benchmarks/fig6_100k.py --full``, one replica):

* ``fig6.mrls_f1.pol.all2all`` -- ``mrls(5832, 18, 18, seed=1)``,
  Polarized, ``max_hops=8``;
* ``fig6.ft50.min.all2all`` -- ``fat_tree(36, 3, a1=18)`` (23,328
  switches), ``minimal_adaptive``, ``max_hops=6``;

and the Figure-5 MRLS ``mrls(614, 18, 18, seed=1)`` (11,052 endpoints,
Polarized, ``max_hops=6``) gives a mid-size point.  ``chip_smoke.py``
runs all three through ``repro_torch`` on the card and holds each Result
to its committed JSON field for field.

Here the Figure-5 point is re-run through the reference package and must
still equal its file.  A fresh reference run at 104,976 endpoints takes
minutes on a CPU, so for the two Figure-6 files the test checks only that
they record the experiments above.

Regenerate the three files with ``PYTHONPATH=src python
tests/test_torch_fig6_reference.py --capture`` (about ten minutes on a
CPU host, most of it the reference's numpy routing tables).
"""
import json
import pathlib
import sys

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def _point(name, network, route):
    return {"network": network, "route": route,
            "workload": {"pattern": "all2all", "rounds": 16},
            "name": name, "max_slots": 60_000}


POINTS = {
    "torch_a2a_fig5_mrls_u18.json": _point(
        "fig5.mrls_u18.pol.all2all",
        {"family": "mrls",
         "params": {"n_leaves": 614, "u": 18, "d": 18, "seed": 1}},
        {"policy": "polarized", "max_hops": 6}),
    "torch_a2a_fig6_mrls_f1.json": _point(
        "fig6.mrls_f1.pol.all2all",
        {"family": "mrls",
         "params": {"n_leaves": 5832, "u": 18, "d": 18, "seed": 1}},
        {"policy": "polarized", "vcs": 4, "max_hops": 8}),
    "torch_a2a_fig6_ft50.json": _point(
        "fig6.ft50.min.all2all",
        {"family": "fat_tree", "params": {"radix": 36, "h": 3, "a1": 18}},
        {"policy": "minimal_adaptive", "vcs": 4, "max_hops": 6}),
}
FIG6_FILES = ("torch_a2a_fig6_mrls_f1.json", "torch_a2a_fig6_ft50.json")


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


def test_committed_fig5_all2all_reference_matches_jax():
    fname = "torch_a2a_fig5_mrls_u18.json"
    assert json.loads((GOLDEN_DIR / fname).read_text()) == \
        reference_result(fname)


@pytest.mark.parametrize("fname", FIG6_FILES)
def test_committed_fig6_references_record_the_paper_points(fname):
    golden = json.loads((GOLDEN_DIR / fname).read_text())
    assert golden["experiment"] == _experiment(fname).to_dict()
    assert golden["metric"] == "completion"
    assert golden["completed"] is True
    assert isinstance(golden["slots"], int) and golden["slots"] > 0


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_fig6_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or tuple(POINTS))
