"""The workload-program layer of the port against the JAX reference.

* ``core.collectives``, ``WorkloadProgram``, ``compile_program`` and
  every builder, array for array, with the same exceptions and messages
  (``register_pattern`` and ``register_program_builder`` included; a
  registered collective then runs through both runners alike).
* The engine's phase scheduler state for state: one JAX simulator runs
  12 + 12 slots of a compiled program from ``make_program_state`` (pool
  4096, run seed 3, so the key goes through ``fold_in``), and the port
  must hold the reference's state key by key (the program arrays, the
  ``phase`` / ``phase_done`` / ``phase_ok`` registers and ``key0``
  included) after 24 slots from its own ``make_program_state``, and
  after 12 slots continued from the reference's 12-slot state.  Cases: a
  barrier Rabenseifner, ring and recursive-doubling allreduce, and a
  windowed all2all and allreduce at windows 1, 2 and ``rounds``, on
  ``mrls(14, 3, 3)`` (Polarized) and ``dragonfly(4, 2, 2)`` (ugal), in
  both of jax's threefry streams.
* ``run_program`` to its end with a forced barrier crossing
  (``max_slots`` below what a phase needs, a ``chunk`` that does not
  divide it): the Result fields and the final state equal the
  reference's.
* Within the port: a barrier program equals the host loop
  (``Traffic("phase")`` + ``run_completion(state=...)``, phase by
  phase), and a windowed all2all with ``window=rounds`` equals the
  free-running ``all2all``, as the reference's own tests hold them.

Tolerance: zero.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro.workloads as jax_wl
import repro.workloads.patterns as jax_patterns
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.workloads as port_wl
import repro_torch.workloads.patterns as port_patterns
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

FABRICS = {
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0), "polarized"),
    "df": ("dragonfly", dict(a=4, p=2, h=2), "ugal"),
}
SEED = 3
# program name -> (builder name, builder arguments but S, schedule, window)
PROGRAMS = {
    "rabenseifner": ("rabenseifner_program", (16, 8), "barrier", 1),
    "ring": ("ring_allreduce_program", (8, 16), "barrier", 1),
    "rd": ("rd_allreduce_program", (16, 4), "barrier", 1),
    **{f"a2a-w{w}": ("all2all_program", (4,), "window", w)
       for w in (1, 2, 4)},
    **{f"allreduce-w{w}": ("rabenseifner_program", (16, 8), "window", w)
       for w in (1, 2, 8)},
}
CASES = [(f, p, pt) for pt in (True, False) for f in FABRICS
         for p in PROGRAMS]


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


def _compiled(pkg, name, S):
    builder, args, schedule, window = PROGRAMS[name]
    prog = getattr(pkg, builder)(S, *args)
    return pkg.compile_program(prog, schedule=schedule, window=window)


def _port_sim(tables, fabric, pt=True):
    return Simulator(tables[fabric][1],
                     SimConfig(**_cfg(FABRICS[fabric][2]),
                               threefry_partitionable=pt), device="cpu")


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


def _raises_alike(fn_ref, fn_port, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# collectives, IR, compiler, builders
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [2, 4, 16, 256])
def test_collective_phases_equal_reference(n):
    for fn in ("rabenseifner_phases", "ring_allreduce_phases",
               "recursive_doubling_phases"):
        for vec in (1, 8, 16, 48):
            want = getattr(jax_core, fn)(n, vec)
            got = getattr(port_core, fn)(n, vec)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g["packets"] == w["packets"]
                np.testing.assert_array_equal(g["partner"], w["partner"])
                assert g["partner"].dtype == w["partner"].dtype
    np.testing.assert_array_equal(port_core.all2all_rounds(n + 3, 5),
                                  jax_core.all2all_rounds(n + 3, 5))
    assert (port_core.all2all_lower_bound_slots(n, 8, 0.7)
            == jax_core.all2all_lower_bound_slots(n, 8, 0.7))
    assert (port_core.allreduce_lower_bound_slots(n, 16, 1.3)
            == jax_core.allreduce_lower_bound_slots(n, 16, 1.3))


def test_collectives_refuse_alike():
    for fn, n in (("rabenseifner_phases", 12), ("ring_allreduce_phases", 1),
                  ("recursive_doubling_phases", 6)):
        _raises_alike(lambda: getattr(jax_core, fn)(n, 8),
                      lambda: getattr(port_core, fn)(n, 8), AssertionError)


@pytest.mark.parametrize("S", [42, 72, 61])
@pytest.mark.parametrize("schedule,window", [("barrier", 1), ("", 1),
                                             ("window", 1), ("window", 3)])
def test_builders_and_compile_equal_reference(S, schedule, window):
    progs = [("all2all_program", (S, 5)),
             ("rabenseifner_program", (S, 32, 16)),
             ("ring_allreduce_program", (S, 7, 16)),
             ("rd_allreduce_program", (S, 16, 3))]
    for builder, args in progs:
        want = getattr(jax_wl, builder)(*args)
        got = getattr(port_wl, builder)(*args)
        assert got.name == want.name
        assert (got.n_phases, got.n_endpoints) == (want.n_phases,
                                                   want.n_endpoints)
        for k in ("partner", "packets"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
            assert getattr(got, k).dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(got.expected(), want.expected())
        cw = jax_wl.compile_program(want, schedule=schedule, window=window)
        cg = port_wl.compile_program(got, schedule=schedule, window=window)
        for f in dataclasses.fields(cw):
            a, b = getattr(cg, f.name), getattr(cw, f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == torch.int32 and a.device.type == "cpu"
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                assert a == b, f.name
        assert cg.total_packets == cw.total_packets
    for pattern, kw in (("all2all", dict(rounds=3)),
                        ("allreduce", dict(vec_packets=8)),
                        ("ring_allreduce", dict(ranks=5)),
                        ("rd_allreduce", dict(ranks=0, vec_packets=2))):
        want = jax_wl.build_collective_program(pattern, S, **kw)
        got = port_wl.build_collective_program(pattern, S, **kw)
        assert got.name == want.name
        np.testing.assert_array_equal(got.partner, want.partner)
        np.testing.assert_array_equal(got.packets, want.packets)


BAD_PROGRAMS = {
    "ndim": (np.zeros(4), np.ones(4)),
    "shape": (np.zeros((2, 4)), np.ones((2, 3))),
    "no phase": (np.zeros((0, 4)), np.ones((0, 4))),
    "partner range": (np.full((1, 4), 4), np.ones((1, 4))),
    "negative partner": (np.full((1, 4), -1), np.ones((1, 4))),
    "negative packets": (np.zeros((1, 4)), -np.ones((1, 4))),
    "empty phase": (np.zeros((2, 4)), np.array([[1, 0, 0, 0], [0] * 4])),
}


@pytest.mark.parametrize("bad", sorted(BAD_PROGRAMS))
def test_program_checks_equal_reference(bad):
    partner, packets = BAD_PROGRAMS[bad]
    _raises_alike(
        lambda: jax_wl.WorkloadProgram("x", partner, packets),
        lambda: port_wl.WorkloadProgram("x", partner, packets))


def test_compile_and_builder_refusals_equal_reference():
    prog = (jax_wl.all2all_program(6, 2), port_wl.all2all_program(6, 2))
    for kw in (dict(schedule="eager"), dict(schedule="window", window=0),
               dict(schedule="barrier", window=2)):
        _raises_alike(lambda: jax_wl.compile_program(prog[0], **kw),
                      lambda: port_wl.compile_program(prog[1], **kw))
    big = np.full((1, 2), 1 << 30)
    huge = [pkg.WorkloadProgram("big", np.array([[1, 0]]), big)
            for pkg in (jax_wl, port_wl)]
    _raises_alike(lambda: jax_wl.compile_program(huge[0]),
                  lambda: port_wl.compile_program(huge[1]))
    for pkgcall in (lambda pkg: pkg.all2all_program(6, 0),
                    lambda pkg: pkg.all2all_program(1, 2),
                    lambda pkg: pkg.rabenseifner_program(6, 8, 4)):
        _raises_alike(lambda: pkgcall(jax_wl), lambda: pkgcall(port_wl))
    # each message lists its own package's registry, which other test
    # modules may extend in the same process
    for pkg in (jax_wl, port_wl):
        with pytest.raises(KeyError) as err:
            pkg.build_collective_program("gather", 8)
        assert err.value.args[0] == (
            "no program builder for pattern 'gather'; known: "
            f"{tuple(sorted(pkg.PROGRAM_BUILDERS))}")


@pytest.fixture
def registry_guard():
    """Take what a test registers back out of both registries."""
    saved = [(jax_wl.PROGRAM_BUILDERS, dict(jax_wl.PROGRAM_BUILDERS)),
             (port_wl.PROGRAM_BUILDERS, dict(port_wl.PROGRAM_BUILDERS)),
             (jax_patterns._KINDS, dict(jax_patterns._KINDS)),
             (port_patterns._KINDS, dict(port_patterns._KINDS))]
    yield
    for live, copy in saved:
        live.clear()
        live.update(copy)


def _pair_exchange(pkg):
    """A custom collective: two phases, the XOR-1 pairs then the XOR-2
    pairs of the even endpoints, ``vec_packets`` packets each."""
    def build(S, *, vec_packets=16, **_kw):
        e = np.arange(S)
        partner = np.stack([e ^ 1, e ^ 2]).clip(max=S - 1)
        packets = np.full((2, S), vec_packets)
        return pkg.WorkloadProgram(f"pairs[{vec_packets}]", partner,
                                   packets)
    return build


def test_register_program_builder_equals_reference(registry_guard):
    for kind_args in (("tornado", "collective"), ("burst2", "kindless")):
        _raises_alike(lambda: jax_patterns.register_pattern(*kind_args),
                      lambda: port_patterns.register_pattern(*kind_args))
    for pkg in (jax_wl, port_wl):
        pkg.register_program_builder("pairs", _pair_exchange(pkg))
    assert (port_patterns.pattern_kinds()["pairs"]
            == jax_patterns.pattern_kinds()["pairs"] == "collective")
    _raises_alike(
        lambda: jax_wl.register_program_builder("pairs", print),
        lambda: port_wl.register_program_builder("pairs", print))
    _raises_alike(
        lambda: jax_wl.register_program_builder("uniform", print),
        lambda: port_wl.register_program_builder("uniform", print))
    d = {"network": {"family": "mrls", "params": {"n_leaves": 14, "u": 3,
                                                  "d": 3, "seed": 0}},
         "route": {"policy": "polarized", "max_hops": 10, "pool": 4096},
         "workload": {"pattern": "pairs", "vec_packets": 3}, "seed": 1}
    want = jax_api.run(jax_api.Experiment.from_dict(d))
    got = port_api.run(port_api.Experiment.from_dict(d), device="cpu")
    assert got.to_dict() == want.to_dict()
    assert got.completed and len(got.phase_slots) == 2
    # overwriting is allowed where asked for, as in the reference
    port_wl.register_program_builder("pairs", _pair_exchange(port_wl),
                                     overwrite=True)
    assert ("pairs", "collective", True) in port_api.workload_patterns()


def test_traffic_fields_keep_the_reference_order():
    want = [f.name for f in dataclasses.fields(JaxTraffic)]
    got = [f.name for f in dataclasses.fields(Traffic)]
    assert got == [n for n in want if n in got]
    # a positional Traffic up to burst_load means the same in both
    assert got[:11] == want[:11] and got[-3:] == want[-3:]
    defaults = {f.name: f.default for f in dataclasses.fields(JaxTraffic)}
    assert all(f.default == defaults[f.name]
               for f in dataclasses.fields(Traffic))


# ---------------------------------------------------------------------- #
# the phase scheduler, state for state
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_states(tables):
    """The reference's program state after 12 and after 24 slots."""
    cache = {}

    def get(fabric, name, pt):
        key = (fabric, name, pt)
        if key not in cache:
            policy = FABRICS[fabric][2]
            with jax.threefry_partitionable(pt), \
                    JaxSimulator(tables[fabric][0],
                                 JaxConfig(**_cfg(policy))) as sim:
                cp = _compiled(jax_wl, name, sim.S)
                tr = sim.program_traffic(cp)
                st = sim.make_program_state(cp, seed=SEED)
                st = sim.run_chunk(st, tr, 12)
                s12 = jax.device_get(st)
                st = sim.run_chunk(st, tr, 12)
                cache[key] = (s12, jax.device_get(st))
        return cache[key]
    return get


def _case_id(case):
    fabric, name, pt = case
    return f"{fabric}-{name}" + ("" if pt else "-original")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_program_state_after_24_slots_equals_reference(tables, jax_states,
                                                       case):
    fabric, name, pt = case
    s12, want = jax_states(*case)
    sim = _port_sim(tables, fabric, pt)
    cp = _compiled(port_wl, name, sim.S)
    tr = sim.program_traffic(cp)
    st = sim.make_program_state(cp, seed=SEED)
    sim.run_chunk(st, tr, 24)
    _assert_states_equal(state_to_numpy(st), want)
    # the run crossed phases (each case's programs are short)
    assert int(st["phase"]) >= 2

    st = state_from_jax(s12, "cpu")
    sim.run_chunk(st, tr, 12)
    _assert_states_equal(state_to_numpy(st), want)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_forced_barrier_crossing_equals_reference(tables, fabric):
    """``max_slots`` 5 is below what most phases need; with ``chunk`` 3
    a stuck phase is forced across at slot 6, the first multiple of 3
    past the budget, counted from its own start."""
    policy = FABRICS[fabric][2]
    with JaxSimulator(tables[fabric][0], JaxConfig(**_cfg(policy))) as sim:
        cp = _compiled(jax_wl, "rabenseifner", sim.S)
        want = sim.run_program(cp, chunk=3, max_slots=5, seed=SEED)
        want_state = jax.device_get(want["state"])
    psim = _port_sim(tables, fabric)
    got = psim.run_program(_compiled(port_wl, "rabenseifner", psim.S),
                           chunk=3, max_slots=5, seed=SEED)
    for k in ("slots", "completed", "pool_stall"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["phase_slots"], want["phase_slots"])
    assert 6 in list(got["phase_slots"]) and not got["completed"]
    _assert_states_equal(state_to_numpy(got["state"]), want_state)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_window_program_run_equals_reference(tables, fabric):
    """A windowed run that reaches ``max_slots`` first: the phases it
    never completed report the final slot."""
    policy = FABRICS[fabric][2]
    out = {}
    for max_slots in (4000, 8):
        with JaxSimulator(tables[fabric][0],
                          JaxConfig(**_cfg(policy))) as sim:
            cp = _compiled(jax_wl, "allreduce-w2", sim.S)
            want = sim.run_program(cp, chunk=4, max_slots=max_slots,
                                   seed=SEED)
            want_state = jax.device_get(want["state"])
        psim = _port_sim(tables, fabric)
        got = psim.run_program(_compiled(port_wl, "allreduce-w2", psim.S),
                               chunk=4, max_slots=max_slots, seed=SEED)
        for k in ("slots", "completed", "pool_stall"):
            assert got[k] == want[k], k
        np.testing.assert_array_equal(got["phase_slots"],
                                      want["phase_slots"])
        _assert_states_equal(state_to_numpy(got["state"]), want_state)
        out[max_slots] = got
    assert out[4000]["completed"] and not out[8]["completed"]
    assert out[8]["slots"] == 8 == out[8]["phase_slots"][-1]


def _host_loop(sim, cp, chunk, max_slots, seed):
    """The per-phase host loop: a fresh ``Traffic("phase")`` state a
    phase, its partner row set by hand, run by ``run_completion``."""
    partner = cp.partner.numpy()
    packets = cp.packets.numpy()
    total, ok, stall, per_phase = 0, True, 0, []
    for p in range(cp.n_phases):
        assert (packets[p] == packets[p, 0]).all()
        tr = Traffic("phase", phase_packets=int(packets[p, 0]))
        st = sim.make_state(tr, seed=seed)
        st["partner"] = torch.as_tensor(partner[p])
        r = sim.run_completion(tr, expected=int(packets[p].sum()),
                               chunk=chunk, max_slots=max_slots, state=st)
        ok &= r["completed"]
        total += r["slots"]
        stall += r["pool_stall"]
        per_phase.append(r["slots"])
    return {"slots": total, "completed": ok, "pool_stall": stall,
            "phase_slots": per_phase}


@pytest.mark.parametrize("fabric", sorted(FABRICS))
@pytest.mark.parametrize("name,max_slots", [("rabenseifner", 3000),
                                            ("ring", 3000),
                                            ("rabenseifner", 5)])
def test_barrier_program_equals_the_host_loop(tables, fabric, name,
                                              max_slots):
    sim = _port_sim(tables, fabric)
    cp = _compiled(port_wl, name, sim.S)
    loop = _host_loop(sim, cp, 3, max_slots, SEED)
    r = sim.run_program(cp, chunk=3, max_slots=max_slots, seed=SEED)
    assert list(r["phase_slots"]) == loop["phase_slots"]
    assert (r["slots"], r["completed"], r["pool_stall"]) == (
        loop["slots"], loop["completed"], loop["pool_stall"])
    assert r["completed"] == (max_slots > 5)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_windowed_all2all_with_full_window_is_the_free_running_all2all(
        tables, fabric):
    sim = _port_sim(tables, fabric)
    cp = _compiled(port_wl, "a2a-w4", sim.S)
    r = sim.run_program(cp, chunk=16, max_slots=4000)
    free = sim.run_completion(Traffic("all2all", rounds=4),
                              expected=sim.S * 4, chunk=16, max_slots=4000)
    assert r["completed"] and free["completed"]
    assert r["slots"] == free["slots"] == int(r["phase_slots"][-1])
    assert r["pool_stall"] == free["pool_stall"]


def test_run_program_refusals(tables):
    sim = _port_sim(tables, "mrls")
    cp = _compiled(port_wl, "rd", sim.S)
    with pytest.raises(NotImplementedError, match="item 6"):
        sim.run_program(cp, seeds=[0, 1])
    with pytest.raises(NotImplementedError, match="item 9"):
        sim.run_program(cp, budget_chunks=2)
    st = sim.make_program_state(cp)
    st["ejected"] = st["ejected"].reshape(1)
    with pytest.raises(NotImplementedError, match="item 6"):
        sim.run_program(cp, state=st)
    with pytest.raises(AssertionError, match="2\\^23"):
        sim.run_program(cp, max_slots=1 << 23)
    other = port_wl.compile_program(port_wl.rd_allreduce_program(40, 16, 4))
    jother = jax_wl.compile_program(jax_wl.rd_allreduce_program(40, 16, 4))
    with JaxSimulator(tables["mrls"][0], JaxConfig(**_cfg("polarized"))) \
            as jsim:
        _raises_alike(lambda: jsim.make_program_state(jother),
                      lambda: sim.make_program_state(other))
