"""The port's ``Result`` record against the reference's.

* ``Result.from_json(r.to_json())`` gives back ``r`` (tuples, the
  latency mapping and the nested experiment included);
* a completion Result with ``phase_slots`` serialises to the reference's
  ``to_dict()`` (lists where the record holds tuples);
* the port loads the reference's records as they come, batched ones too:
  a throughput and an allreduce run with ``replicas=2``, whose
  ``replica_seeds``, ``per_replica`` (with a per-replica tuple of
  ``phase_slots`` rows) and ``aggregates`` are filled, and a latency
  record whose percentiles may be ``None``.

Tolerance: zero.
"""
import json

import pytest
import torch

import repro.api as jax_api
import repro_torch.api as port_api

TINY = {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3,
                                     "seed": 0}}
ROUTE = {"policy": "polarized", "max_hops": 10, "pool": 4096}
ALLREDUCE = {"network": TINY, "route": ROUTE,
             "workload": {"pattern": "allreduce", "ranks": 16,
                          "vec_packets": 8},
             "seed": 1, "max_slots": 3000, "name": "tiny.allreduce"}
THROUGHPUT = {"network": TINY, "route": ROUTE,
              "workload": {"pattern": "uniform", "load": 0.4},
              "warm": 10, "measure": 20, "name": "tiny.uniform"}
LATENCY = dict(THROUGHPUT, metric="latency", name="tiny.latency")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_allreduce():
    return port_api.run(port_api.Experiment.from_dict(ALLREDUCE),
                        device="cpu")


def test_completion_result_to_dict_equals_reference(port_allreduce):
    want = jax_api.run(jax_api.Experiment.from_dict(ALLREDUCE))
    assert isinstance(port_allreduce.phase_slots, tuple)
    d = port_allreduce.to_dict()
    assert d == want.to_dict()
    assert isinstance(d["phase_slots"], list) and len(d["phase_slots"]) == 8


@pytest.mark.parametrize("indent", [None, 1])
def test_port_result_round_trips_through_json(port_allreduce, indent):
    r = port_allreduce
    assert port_api.Result.from_json(r.to_json(indent=indent)) == r
    lat = port_api.run(port_api.Experiment.from_dict(LATENCY),
                       device="cpu")
    back = port_api.Result.from_json(lat.to_json())
    assert back == lat and back.latency == lat.latency
    assert port_api.Result.from_dict(r.to_dict()).to_dict() == r.to_dict()


@pytest.mark.parametrize("doc", [ALLREDUCE, THROUGHPUT, LATENCY],
                         ids=["allreduce", "throughput", "latency"])
@pytest.mark.parametrize("replicas", [1, 2])
def test_port_loads_the_reference_records(doc, replicas):
    ref = jax_api.run(jax_api.Experiment.from_dict(
        dict(doc, replicas=replicas)))
    text = ref.to_json()
    got = port_api.Result.from_json(text)
    want = jax_api.Result.from_json(text)
    # to_dict() as the reference's (which keeps the per-replica
    # phase_slots rows as tuples), and the same JSON text
    assert got.to_dict() == ref.to_dict()
    assert got.to_json() == text
    for field in ("metric", "slots", "completed", "phase_slots",
                  "replica_seeds", "per_replica", "aggregates", "latency",
                  "throughput", "pool_stall"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.experiment.to_dict() == want.experiment.to_dict()
    if replicas == 2:
        assert got.replica_seeds == (doc.get("seed", 0),
                                     doc.get("seed", 0) + 1)
        assert set(got.aggregates) <= set(got.per_replica)
        if doc is ALLREDUCE:
            rows = got.per_replica["phase_slots"]
            assert isinstance(rows, tuple) and len(rows) == 2
            assert all(isinstance(r, tuple) and len(r) == 8 for r in rows)
    assert port_api.Result.from_json(got.to_json()) == got
