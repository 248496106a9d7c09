"""The port's engine against the reference engine, state for state.

On the golden fabric ``mrls(14, 3, 3, seed=0)`` (pool 4096,
``max_hops=10``, uniform load 0.7, run seed 3 so the key goes through
``fold_in``), one JAX simulator runs 12 + 12 slots.  The port must hold
the reference's state key by key after 24 slots from ``make_state``, and
after 12 slots continued from the reference's own 12-slot state
(carried across with ``repro_torch.convert``).  Tolerance: zero.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

FABRIC = dict(n_leaves=14, u=3, d=3, seed=0)
CFG = dict(policy="polarized", max_hops=10, pool=4096)
LOAD, SEED = 0.7, 3


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
def jax_states():
    """The reference's state after 12 and after 24 slots."""
    tables = jax_core.build_tables(jax_core.mrls(**FABRIC))
    tr = JaxTraffic("uniform", load=LOAD)
    with JaxSimulator(tables, JaxConfig(**CFG)) as sim:
        st = sim.make_state(tr, seed=SEED)
        st = sim.run_chunk(st, tr, 12)
        s12 = jax.device_get(st)
        st = sim.run_chunk(st, tr, 12)
        s24 = jax.device_get(st)
    return s12, s24


@pytest.fixture(scope="module")
def port_sim():
    tables = port_core.build_tables(port_core.mrls(**FABRIC), device="cpu")
    return Simulator(tables, SimConfig(**CFG), device="cpu")


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


def test_state_after_24_slots_equals_reference(jax_states, port_sim):
    tr = Traffic("uniform", load=LOAD)
    st = port_sim.make_state(tr, seed=SEED)
    port_sim.run_chunk(st, tr, 24)
    _assert_states_equal(state_to_numpy(st), jax_states[1])


def test_carried_state_continues_bitwise(jax_states, port_sim):
    s12, s24 = jax_states
    st = state_from_jax(s12, "cpu")
    port_sim.run_chunk(st, Traffic("uniform", load=LOAD), 12)
    _assert_states_equal(state_to_numpy(st), s24)


def test_state_conversion_round_trips(jax_states):
    s12 = jax_states[0]
    _assert_states_equal(state_to_numpy(state_from_jax(s12, "cpu")), s12)


def test_fresh_state_matches_reference_layout(jax_states, port_sim):
    st = state_to_numpy(port_sim.make_state(Traffic("uniform", LOAD)))
    want = jax_states[0]
    for k in want:
        assert st[k].shape == np.asarray(want[k]).shape, k
        assert st[k].dtype == np.asarray(want[k]).dtype, k


def test_unported_policies_and_patterns_raise(port_sim):
    tables = port_sim.tables
    # degraded runs now (tests/test_torch_failures.py): it keeps the away
    # bits, and with no schedule the simulator is not armed
    sim = Simulator(tables, SimConfig(policy="degraded"), device="cpu")
    assert sim.away_mask is not None and not sim.has_failures
    assert torch.equal(sim.min_mask, port_sim.min_mask)
    with pytest.raises(ValueError, match="unknown policy"):
        Simulator(tables, SimConfig(policy="shortest"), device="cpu")
    # the open-loop arrival source runs; its process is checked
    assert Traffic("arrival", process="diurnal").process == "diurnal"
    with pytest.raises(ValueError, match="unknown arrival process"):
        Traffic("arrival", process="bursty")
    with pytest.raises(ValueError, match="arrival family"):
        Traffic("poisson")
    with pytest.raises(ValueError, match="unknown pattern"):
        Traffic("nonsense")
