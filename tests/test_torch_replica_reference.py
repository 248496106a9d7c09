"""The JAX reference's 4-replica Results of Figure 5's MRLS row.

``benchmarks/fig5_11k.py --full`` runs every experiment with 4 replicas
(``bench_sim.cli_replicas``).  ``chip_smoke.py`` phase 15 runs two of
its points through ``repro_torch`` on the card and holds them, field for
field, to the reference's Results committed here:

* ``torch_rep_fig5_mrls_uniform_r4.json`` -- ``fig5.mrls_u18.pol`` under
  uniform traffic at load 1.0, warm 300 / measure 300, ``replicas=4``
  (seeds 0-3): one batched ``repro.api.run`` Result, with its
  ``per_replica``, ``aggregates`` and ``replica_seeds``;
* ``torch_rep_fig5_mrls_allreduce_r4.json`` -- the Rabenseifner
  allreduce over 8,192 ranks of 16 packets (26 phases, ``max_slots``
  30,000) as four seed-only experiments (seeds 0-3) through
  ``repro.api.run_all``, which folds them into one batched run and
  splits the Results back out: a list of four Results.

Replica 0 of each is the scalar point of ``torch_fig5_mrls_u18.json``
and ``torch_prog_fig5_mrls_allreduce.json``; the test checks that, and
that each file records its experiments.  The full-size runs take minutes
on a CPU, so the test reads the files and does not rerun them.

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_replica_reference.py --capture [file ...]`` (jax's
partitionable threefry stream).  Tolerance: zero.
"""
import copy
import json
import pathlib
import sys

import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
sys.path.insert(0, str(pathlib.Path(__file__).parent))

from test_torch_fig5_reference import FIG5_POINT  # noqa: E402
from test_torch_program_reference import POINTS as PROGRAM_POINTS  # noqa: E402

REPLICAS = 4
UNIFORM = "torch_rep_fig5_mrls_uniform_r4.json"
ALLREDUCE = "torch_rep_fig5_mrls_allreduce_r4.json"
SCALAR_UNIFORM = "torch_fig5_mrls_u18.json"
SCALAR_ALLREDUCE = "torch_prog_fig5_mrls_allreduce.json"


def uniform_point() -> dict:
    """The batched uniform experiment: the scalar point with 4 replicas."""
    return dict(FIG5_POINT, replicas=REPLICAS)


def allreduce_points() -> list:
    """Four seed-only allreduce experiments, seeds 0-3: one folded group
    of ``run_all``."""
    base = PROGRAM_POINTS[SCALAR_ALLREDUCE]
    return [dict(copy.deepcopy(base), seed=s) for s in range(REPLICAS)]


def reference_records(fname):
    """The reference package's Result(s) of one file, as dicts."""
    from repro.api import Experiment, run, run_all
    if fname == UNIFORM:
        return run(Experiment.from_dict(uniform_point())).to_dict()
    return [r.to_dict() for r in run_all(
        [Experiment.from_dict(d) for d in allreduce_points()])]


def capture(names=(UNIFORM, ALLREDUCE)) -> None:
    """Write the reference Results of ``names`` into ``tests/golden``."""
    for fname in names:
        path = GOLDEN_DIR / fname
        path.write_text(json.dumps(reference_records(fname), indent=1,
                                   sort_keys=True) + "\n")
        print(f"wrote {path}", flush=True)


def _load(fname):
    return json.loads((GOLDEN_DIR / fname).read_text())


# the per-replica fields a throughput Result carries, and its mean fields
THROUGHPUT_FIELDS = ("throughput", "avg_hops", "ejected", "pool_stall")


def test_uniform_golden_records_the_batched_point():
    from repro_torch.api import Experiment
    golden = _load(UNIFORM)
    exp = Experiment.from_dict(uniform_point())
    assert golden["experiment"] == exp.to_dict()
    assert golden["metric"] == "throughput"
    assert golden["replica_seeds"] == [0, 1, 2, 3]
    assert sorted(golden["per_replica"]) == sorted(THROUGHPUT_FIELDS)
    assert sorted(golden["aggregates"]) == sorted(THROUGHPUT_FIELDS)
    for k in THROUGHPUT_FIELDS:
        assert len(golden["per_replica"][k]) == REPLICAS
        assert golden[k] == golden["aggregates"][k]["mean"]


def test_uniform_golden_replica_0_is_the_scalar_golden():
    golden, scalar = _load(UNIFORM), _load(SCALAR_UNIFORM)
    for k in THROUGHPUT_FIELDS:
        assert golden["per_replica"][k][0] == scalar[k], k
    # the other replicas run other seeds
    assert len(set(golden["per_replica"]["ejected"])) == REPLICAS


def test_allreduce_golden_records_the_folded_points():
    from repro_torch.api import Experiment
    golden = _load(ALLREDUCE)
    assert len(golden) == REPLICAS
    for rec, d in zip(golden, allreduce_points()):
        assert rec["experiment"] == Experiment.from_dict(d).to_dict()
        assert rec["metric"] == "completion" and rec["completed"] is True
        # an unfolded Result is a scalar one: no replica fields
        assert rec["per_replica"] is None and rec["replica_seeds"] is None
        assert len(rec["phase_slots"]) == 26
        assert rec["slots"] == sum(rec["phase_slots"])


def test_allreduce_golden_replica_0_is_the_scalar_golden():
    rec, scalar = _load(ALLREDUCE)[0], _load(SCALAR_ALLREDUCE)
    for k in ("slots", "completed", "phase_slots", "pool_stall"):
        assert rec[k] == scalar[k], k
    assert scalar["slots"] == 362


@pytest.mark.parametrize("fname", (UNIFORM, ALLREDUCE))
def test_replica_goldens_load_as_port_results(fname):
    from repro_torch.api import Result
    golden = _load(fname)
    for rec in golden if isinstance(golden, list) else [golden]:
        assert Result.from_dict(rec).to_dict() == rec


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_replica_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or (UNIFORM, ALLREDUCE))
