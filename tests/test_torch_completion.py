"""All2All completion runs of the port against the reference.

``repro_torch.api.run(..., device="cpu")`` must return the reference's
``completion`` Result field for field: on the golden MRLS under the
three ported policies, on a depopulated Fat-Tree, with a ``chunk`` that
does not divide the completion slot, and with a ``max_slots`` that the
run misses.  After ``Simulator.run_completion`` the port's state equals
the reference's key by key; both sit on the chunk boundary where the
loop stopped, not at the completion slot.  Tolerance: zero.
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.convert import state_to_numpy
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

GOLDEN_MRLS = {"family": "mrls",
               "params": {"n_leaves": 14, "u": 3, "d": 3, "seed": 0}}
FAT_TREE = {"family": "fat_tree", "params": {"radix": 8, "h": 3, "a1": 4}}
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _experiment(network, policy, max_hops, **kw):
    return {"network": network,
            "route": {"policy": policy, "max_hops": max_hops, "pool": 4096},
            "workload": {"pattern": "all2all", "rounds": ROUNDS}, **kw}


CASES = {
    "mrls-polarized": _experiment(GOLDEN_MRLS, "polarized", 10),
    "mrls-minimal_adaptive": _experiment(GOLDEN_MRLS, "minimal_adaptive",
                                         10),
    "mrls-ksp": _experiment(GOLDEN_MRLS, "ksp", 10, seed=3),
    "fat_tree-minimal_adaptive": _experiment(FAT_TREE, "minimal_adaptive",
                                             6),
    "mrls-polarized-chunk5": _experiment(GOLDEN_MRLS, "polarized", 10,
                                         chunk=5),
    "mrls-polarized-missed": _experiment(GOLDEN_MRLS, "polarized", 10,
                                         chunk=4, max_slots=6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_completion_result_matches_reference(case):
    d = CASES[case]
    want = jax_api.run(jax_api.Experiment.from_dict(d)).to_dict()
    got = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    assert got.metric == "completion"
    assert got.to_dict() == want
    if case.endswith("chunk5"):
        assert want["completed"] and want["slots"] % 5 != 0
    elif case.endswith("missed"):
        # two chunks of 4 ran before the test at slot 8 >= 6 stopped it
        assert want["completed"] is False and want["slots"] == 8
    else:
        assert want["completed"] is True


@pytest.fixture(scope="module")
def sims():
    """One simulator of each package on the golden MRLS, Polarized."""
    cfg = dict(policy="polarized", max_hops=10, pool=4096)
    ref = JaxSimulator(jax_core.build_tables(jax_core.mrls(14, 3, 3, seed=0)),
                       JaxConfig(**cfg))
    port = Simulator(port_core.build_tables(port_core.mrls(14, 3, 3, seed=0),
                                            device="cpu"),
                     SimConfig(**cfg), device="cpu")
    yield ref, port
    ref.close()


@pytest.mark.parametrize("chunk,max_slots,seed", [(5, 1000, 0),
                                                  (4, 6, 2)])
def test_final_state_matches_reference(sims, chunk, max_slots, seed):
    ref_sim, port_sim = sims
    expected = port_sim.S * ROUNDS
    want = ref_sim.run_completion(JaxTraffic("all2all", rounds=ROUNDS),
                                  expected, chunk=chunk,
                                  max_slots=max_slots, seed=seed)
    got = port_sim.run_completion(Traffic("all2all", rounds=ROUNDS),
                                  expected, chunk=chunk,
                                  max_slots=max_slots, seed=seed)
    for k in ("slots", "completed", "pool_stall"):
        assert got[k] == want[k], k
    want_st = jax.device_get(want["state"])
    got_st = state_to_numpy(got["state"])
    assert set(got_st) == set(want_st)
    for k, w in want_st.items():
        w = np.asarray(w)
        assert got_st[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got_st[k], w, err_msg=f"state[{k!r}]")
    # the state sits on the chunk boundary past the completion slot
    assert int(got_st["slot"]) % chunk == 0
    assert int(got_st["slot"]) >= got["slots"]


def test_completion_refuses_a_slot_count_that_overflows(sims):
    with pytest.raises(AssertionError, match="2\\^23"):
        sims[1].run_completion(Traffic("all2all", rounds=1), 1,
                               max_slots=1 << 23)
