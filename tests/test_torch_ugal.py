"""UGAL, Valiant and the Figure-7 Bernoulli families against the
reference engine, state for state.

As ``tests/test_torch_engine.py`` does for Polarized under uniform load:
one JAX simulator runs 12 + 12 slots (pool 4096, run seed 3, so the key
goes through ``fold_in``), and the port must hold the reference's state
key by key after 24 slots from ``make_state``, and after 12 slots
continued from the reference's own 12-slot state (carried across with
``repro_torch.convert``).  Cases:

* ``ugal`` and ``valiant`` under uniform load on ``dragonfly(4, 2, 2)``
  (a direct network: every switch is a leaf), ``dragonfly_plus(5, 4, 4,
  4, 4)`` (half of each leaf's ports unlinked) and the golden
  ``mrls(14, 3, 3)``, and ``ugal`` on ``dragonfly_plus(13, 6, 6, 6, 6)``;
* ``rep``, ``rsp``, ``bu`` and ``mice_elephant`` under Polarized on the
  golden MRLS and under ``ugal`` on ``dragonfly(4, 2, 2)``.

Also one All2All ``Result`` of ``dragonfly(4, 2, 2)`` under ``ugal`` and
one ``mice_elephant`` latency ``Result`` against ``repro.api.run``.
Tolerance: zero.
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
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

FABRICS = {
    "df": ("dragonfly", dict(a=4, p=2, h=2)),
    "dfplus": ("dragonfly_plus", dict(n_groups=5, leaves_per_group=4,
                                      spines_per_group=4, p=4,
                                      global_per_spine=4)),
    "dfplus13": ("dragonfly_plus", dict(n_groups=13, leaves_per_group=6,
                                        spines_per_group=6, p=6,
                                        global_per_spine=6)),
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
}
LOADS = {"uniform": 0.7, "rep": 0.7, "rsp": 0.7, "bu": 0.7,
         "mice_elephant": 0.5}
SEED = 3
CASES = ([(f, pol, "uniform") for pol in ("ugal", "valiant")
          for f in ("df", "dfplus", "mrls")]
         + [("dfplus13", "ugal", "uniform")]
         + [(f, pol, pat) for f, pol in (("mrls", "polarized"),
                                         ("df", "ugal"))
            for pat in ("rep", "rsp", "bu", "mice_elephant")])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(policy):
    return dict(policy=policy, max_hops=10, pool=4096)


@pytest.fixture(scope="module")
def tables():
    """``{fabric: (reference tables, port tables)}``."""
    return {name: (jax_core.build_tables(getattr(jax_core, fam)(**params)),
                   port_core.build_tables(getattr(port_core, fam)(**params),
                                          device="cpu"))
            for name, (fam, params) in FABRICS.items()}


@pytest.fixture(scope="module")
def jax_states(tables):
    """The reference's state after 12 and after 24 slots, per case."""
    cache = {}

    def get(fabric, policy, pattern):
        key = (fabric, policy, pattern)
        if key not in cache:
            tr = JaxTraffic(pattern, load=LOADS[pattern])
            with JaxSimulator(tables[fabric][0],
                              JaxConfig(**_cfg(policy))) as sim:
                st = sim.make_state(tr, seed=SEED)
                st = sim.run_chunk(st, tr, 12)
                s12 = jax.device_get(st)
                st = sim.run_chunk(st, tr, 12)
                cache[key] = (s12, jax.device_get(st))
        return cache[key]
    return get


def _port_sim(tables, fabric, policy):
    return Simulator(tables[fabric][1], SimConfig(**_cfg(policy)),
                     device="cpu")


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


@pytest.mark.parametrize("fabric,policy,pattern", CASES, ids=str)
def test_state_after_24_slots_equals_reference(tables, jax_states, fabric,
                                               policy, pattern):
    want = jax_states(fabric, policy, pattern)[1]
    sim = _port_sim(tables, fabric, policy)
    tr = Traffic(pattern, load=LOADS[pattern])
    st = sim.make_state(tr, seed=SEED)
    sim.run_chunk(st, tr, 24)
    got = state_to_numpy(st)
    _assert_states_equal(got, want)
    assert got["ejected"] > 0
    if pattern == "uniform":
        # some packets are on their way to an intermediate leaf, except
        # under ugal on dragonfly_plus(5, 4, 4, 4, 4): there every spine
        # of a group links to every other group, so the minimal and the
        # Valiant ports are the same spines, q_min == q_val, and
        # q_min * d_min > q_val * d_val never holds
        s12 = jax_states(fabric, policy, pattern)[0]
        detours = int((s12["p_mid"] >= 0).sum() + (got["p_mid"] >= 0).sum())
        assert (detours == 0) == (fabric == "dfplus" and policy == "ugal")


@pytest.mark.parametrize("fabric,policy,pattern", CASES, ids=str)
def test_carried_state_continues_bitwise(tables, jax_states, fabric, policy,
                                         pattern):
    s12, s24 = jax_states(fabric, policy, pattern)
    sim = _port_sim(tables, fabric, policy)
    st = state_from_jax(s12, "cpu")
    sim.run_chunk(st, Traffic(pattern, load=LOADS[pattern]), 12)
    _assert_states_equal(state_to_numpy(st), s24)


def _run_both(d: dict):
    ref = jax_api.run(jax_api.Experiment.from_dict(d))
    got = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    return got.to_dict(), ref.to_dict()


def test_dragonfly_ugal_all2all_result_equals_reference():
    family, params = FABRICS["df"]
    got, want = _run_both({
        "network": {"family": family, "params": params},
        "route": {"policy": "ugal", "max_hops": 6},
        "workload": {"pattern": "all2all", "rounds": 4},
        "name": "df.ugal.all2all"})
    assert got == want
    assert got["completed"] is True


def test_mice_elephant_latency_result_equals_reference():
    family, params = FABRICS["df"]
    got, want = _run_both({
        "network": {"family": family, "params": params},
        "route": {"policy": "ugal", "max_hops": 6},
        "workload": {"pattern": "mice_elephant", "load": 0.5},
        "metric": "latency", "warm": 20, "measure": 40})
    assert got == want
    assert got["latency"]["p50"] >= 1
