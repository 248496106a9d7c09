"""The adversarial Bernoulli families against the reference engine,
state for state: ``tornado``, ``shift``, ``hotspot`` and ``bursty``.

As ``tests/test_torch_ugal.py`` does: one JAX simulator runs 12 + 12
slots (pool 4096, run seed 3, so the key goes through ``fold_in``), and
the port must hold the reference's state key by key (``burst``, the
on-off state of ``bursty``, included) after 24 slots from
``make_state``, and after 12 slots continued from the reference's own
12-slot state.  Cases:

* each family on ``mrls(14, 3, 3)`` (Polarized), ``oft(5)`` (Polarized),
  ``dragonfly(4, 2, 2)`` (ugal) and ``jellyfish(24, 5, 3, seed=2)``
  (minimal_adaptive), in jax's partitionable threefry stream;
* ``bursty`` and ``hotspot`` in the original stream too (the nested
  ``split`` of their third key), and ``hotspot`` with one hot endpoint
  (a ``randint`` of span 1, which still draws its two bit batches);
* ``shift`` by S - 1, S + 1, a negative offset and 2**31 - 1 (the int32
  sum wraps, as jax's does); a shift past int32 is refused by both.

Also the validators of ``make_state`` and ``WorkloadSpec`` (the same
exceptions with the same messages) and one Result per family through
``repro_torch.api.run(..., device="cpu")`` against ``repro.api.run``.
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
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0), "polarized"),
    "oft": ("oft", dict(q=5), "polarized"),
    "df": ("dragonfly", dict(a=4, p=2, h=2), "ugal"),
    "jf": ("jellyfish", dict(n_switches=24, r=5, d=3, seed=2),
           "minimal_adaptive"),
}
S_MRLS = 42
FAMILIES = {
    "tornado": dict(load=0.7),
    "shift": dict(load=0.7, shift=3),
    "hotspot": dict(load=0.7, hot_frac=0.3, hot_count=2),
    "bursty": dict(load=0.5, burst_load=0.9, burst_len=4.0),
}
SEED = 3
# (fabric, pattern, traffic knobs, partitionable stream)
CASES = [(f, p, kw, True) for f in FABRICS for p, kw in FAMILIES.items()]
EXTRA = ([(f, p, FAMILIES[p], False) for f in ("mrls", "oft")
          for p in ("bursty", "hotspot")]
         + [("mrls", "hotspot", dict(load=0.7, hot_frac=0.3, hot_count=1),
             True)]
         + [("mrls", "shift", dict(load=0.7, shift=s), True)
            for s in (S_MRLS - 1, S_MRLS + 1, -5, 2 ** 31 - 1)])


def _id(case):
    fabric, pattern, kw, pt = case
    knobs = ",".join(f"{k}={v}" for k, v in kw.items() if k != "load")
    return f"{fabric}-{pattern}[{knobs}]" + ("" if pt else "-original")


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
            for name, (fam, params, _) in FABRICS.items()}


@pytest.fixture(scope="module")
def jax_states(tables):
    """The reference's state after 12 and after 24 slots, per case."""
    cache = {}

    def get(fabric, pattern, kw, pt):
        key = (fabric, pattern, tuple(sorted(kw.items())), pt)
        if key not in cache:
            tr = JaxTraffic(pattern, **kw)
            policy = FABRICS[fabric][2]
            with jax.threefry_partitionable(pt), \
                    JaxSimulator(tables[fabric][0],
                                 JaxConfig(**_cfg(policy))) as sim:
                st = sim.make_state(tr, seed=SEED)
                st = sim.run_chunk(st, tr, 12)
                s12 = jax.device_get(st)
                st = sim.run_chunk(st, tr, 12)
                cache[key] = (s12, jax.device_get(st))
        return cache[key]
    return get


def _port_sim(tables, fabric, pt=True):
    return Simulator(tables[fabric][1],
                     SimConfig(**_cfg(FABRICS[fabric][2]),
                               threefry_partitionable=pt),
                     device="cpu")


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


@pytest.mark.parametrize("case", CASES + EXTRA, ids=_id)
def test_state_after_24_slots_equals_reference(tables, jax_states, case):
    fabric, pattern, kw, pt = case
    s12, want = jax_states(*case)
    sim = _port_sim(tables, fabric, pt)
    tr = Traffic(pattern, **kw)
    st = sim.make_state(tr, seed=SEED)
    sim.run_chunk(st, tr, 24)
    got = state_to_numpy(st)
    _assert_states_equal(got, want)
    assert got["ejected"] > 0
    if pattern == "bursty":
        # endpoints were on in some slot and off in another
        assert 0 < s12["burst"].sum() + got["burst"].sum()
        assert (got["burst"] == 0).any()


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_carried_state_continues_bitwise(tables, jax_states, case):
    fabric, pattern, kw, pt = case
    s12, s24 = jax_states(*case)
    sim = _port_sim(tables, fabric, pt)
    st = state_from_jax(s12, "cpu")
    sim.run_chunk(st, Traffic(pattern, **kw), 12)
    _assert_states_equal(state_to_numpy(st), s24)


def test_destinations_of_the_fixed_families(tables):
    """tornado sends every endpoint to the same slot of the leaf halfway
    around; shift to (e + shift) mod S, wrapping in int32 like jax."""
    sim = _port_sim(tables, "mrls")
    e = np.arange(S_MRLS)
    st = sim.make_batch_state(Traffic("tornado", load=1.0), [0])
    sim._inject(st, st["key"], Traffic("tornado", load=1.0))
    np.testing.assert_array_equal(st["msg_dst"][0].numpy(),
                                  ((e // 3 + 7) % 14) * 3 + e % 3)
    for shift in (-5, S_MRLS + 1, 2 ** 31 - 1, -2 ** 31):
        tr = Traffic("shift", load=1.0, shift=shift)
        st = sim.make_batch_state(tr, [0])
        sim._inject(st, st["key"], tr)
        want = ((e.astype(np.int64) + shift + 2 ** 31) % 2 ** 32
                - 2 ** 31) % S_MRLS
        np.testing.assert_array_equal(st["msg_dst"][0].numpy(), want)


def test_shift_past_int32_is_refused_like_the_reference(tables):
    tr = dict(load=0.7, shift=2 ** 31)
    with pytest.raises(OverflowError, match="int32"):
        _port_sim(tables, "mrls").make_state(Traffic("shift", **tr))
    with JaxSimulator(tables["mrls"][0], JaxConfig(**_cfg("polarized"))) \
            as sim:
        st = sim.make_state(JaxTraffic("shift", **tr))
        with pytest.raises(OverflowError):
            sim.run_chunk(st, JaxTraffic("shift", **tr), 1)


# ---------------------------------------------------------------------- #
# validators
# ---------------------------------------------------------------------- #
BAD_TRAFFIC = [
    ("mrls", "shift", dict(shift=0)),
    ("mrls", "shift", dict(shift=2 * S_MRLS)),
    ("mrls", "shift", dict(shift=-S_MRLS)),
    ("mrls", "hotspot", dict(hot_count=S_MRLS + 1)),
    ("mrls", "bursty", dict(load=0.95, burst_load=0.9)),
    ("mrls", "bursty", dict(load=0.85, burst_load=0.9, burst_len=4.0)),
]


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("fabric,pattern,kw", BAD_TRAFFIC, ids=str)
def test_make_state_refuses_like_the_reference(tables, fabric, pattern, kw):
    port = _port_sim(tables, fabric)
    with JaxSimulator(tables[fabric][0],
                      JaxConfig(**_cfg(FABRICS[fabric][2]))) as ref:
        want = _raised(lambda: ref.make_state(JaxTraffic(pattern, **kw)))
    assert want[0] is ValueError
    assert _raised(lambda: port.make_state(Traffic(pattern, **kw))) == want


def test_tornado_on_one_leaf_is_refused_like_the_reference():
    # one leaf of one endpoint under one root switch
    topo = dict(radix=2, h=1, a1=1)
    port = Simulator(port_core.build_tables(port_core.fat_tree(**topo),
                                            device="cpu"),
                     SimConfig(), device="cpu")
    want = "tornado needs at least 2 leaves"
    with pytest.raises(ValueError, match=want):
        port.make_state(Traffic("tornado"))
    with JaxSimulator(jax_core.build_tables(jax_core.fat_tree(**topo)),
                      JaxConfig()) as ref:
        with pytest.raises(ValueError, match=want):
            ref.make_state(JaxTraffic("tornado"))


BAD_SPECS = [
    dict(pattern="shift", shift=0),
    dict(pattern="hotspot", hot_frac=0.0),
    dict(pattern="hotspot", hot_frac=1.5),
    dict(pattern="hotspot", hot_count=0),
    dict(pattern="bursty", burst_load=0.0),
    dict(pattern="bursty", burst_load=1.2),
    dict(pattern="bursty", burst_len=0.5),
    dict(pattern="bursty", load=0.8, burst_load=0.5),
    dict(pattern="bursty", load=0.9, burst_load=1.0, burst_len=4.0),
    dict(pattern="allreduce", ranks=6),
    dict(pattern="rd_allreduce", ranks=1),
    dict(pattern="ring_allreduce", ranks=1),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=str)
def test_workload_spec_refuses_like_the_reference(kw):
    want = _raised(lambda: jax_api.WorkloadSpec(**kw))
    assert want[0] is ValueError
    assert _raised(lambda: port_api.WorkloadSpec(**kw)) == want


def test_valid_knobs_are_accepted_by_both():
    for kw in (dict(pattern="shift", shift=-3),
               dict(pattern="hotspot", hot_frac=1.0, hot_count=5),
               dict(pattern="bursty", load=0.8, burst_load=1.0,
                    burst_len=4.0)):
        assert port_api.WorkloadSpec(**kw).to_dict() == \
            jax_api.WorkloadSpec(**kw).to_dict()


# ---------------------------------------------------------------------- #
# Results through the API
# ---------------------------------------------------------------------- #
RESULTS = [
    ("tornado", dict(load=0.5), "auto"),
    ("shift", dict(load=1.0, shift=3), "auto"),
    ("hotspot", dict(load=0.7, hot_frac=0.1, hot_count=1), "auto"),
    ("bursty", dict(load=0.5, burst_load=1.0, burst_len=8.0), "latency"),
]


@pytest.mark.parametrize("pattern,kw,metric", RESULTS,
                         ids=[r[0] for r in RESULTS])
def test_result_equals_reference(pattern, kw, metric):
    family, params, policy = FABRICS["mrls"]
    d = {"network": {"family": family, "params": params},
         "route": {"policy": policy, "max_hops": 6},
         "workload": {"pattern": pattern, **kw},
         "metric": metric, "warm": 20, "measure": 40}
    want = jax_api.run(jax_api.Experiment.from_dict(d)).to_dict()
    got = port_api.run(port_api.Experiment.from_dict(d),
                       device="cpu").to_dict()
    assert got == want
    if metric == "auto":
        assert got["ejected"] > 0
