"""The JAX reference Result of the port's full-width point.

Figure 5's cost-matched MRLS (``benchmarks/fig5_11k.py --full``:
``mrls(614, 18, 18, seed=1)``, 11,052 endpoints, Polarized with
``max_hops=6``) under uniform traffic at load 1.0, warm 300 / measure
300 slots.  ``chip_smoke.py`` runs this point through ``repro_torch`` on
the card and holds its Result to ``tests/golden/torch_fig5_mrls_u18.json``
field for field; this test keeps that file equal to what the reference
package computes today.

Regenerate the file with ``PYTHONPATH=src python
tests/test_torch_fig5_reference.py``.
"""
import json
import pathlib

GOLDEN = (pathlib.Path(__file__).parent / "golden"
          / "torch_fig5_mrls_u18.json")

FIG5_POINT = {
    "network": {"family": "mrls",
                "params": {"n_leaves": 614, "u": 18, "d": 18, "seed": 1}},
    "route": {"policy": "polarized", "max_hops": 6},
    "workload": {"pattern": "uniform", "load": 1.0},
    "name": "fig5.mrls_u18.pol.uniform",
    "warm": 300,
    "measure": 300,
}


def reference_result() -> dict:
    """The reference package's Result of the Fig-5 point, as a dict."""
    from repro.api import Experiment, run
    return run(Experiment.from_dict(FIG5_POINT)).to_dict()


def test_committed_fig5_reference_matches_jax():
    assert json.loads(GOLDEN.read_text()) == reference_result()


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(reference_result(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}")
