"""Replicas: one batched step for R seeds, held to the reference's vmap.

The reference runs R replicas as one ``jax.vmap``-ed computation; the
port runs them as one step over states with a leading ``[R]`` axis.
Each case is held against the live reference at small sizes
(``mrls(14, 3, 3)`` under Polarized, ``dragonfly(4, 2, 2)`` under UGAL
and ``fat_tree(4, 1)`` under KSP; pool 4096, seeds 0, 3 and 5):

* ``make_batch_state`` and ``make_program_batch_state`` equal the
  reference's key for key (``convert.state_to_numpy``), the program's
  arrays unstacked;
* ``run_chunk_batch`` state for state on ``uniform``, ``rep``, ``rsp``
  and ``bursty`` (the seed-dependent branches), in both threefry modes
  (every fabric and pattern in the partitionable one, each pattern in
  the original one);
  and each replica equals the port's scalar run of its seed;
* ``run_throughput_batch``, ``run_latency_batch``, a batched
  ``run_completion`` and ``run_program(seeds=)`` under ``barrier`` and
  ``window`` equal the reference's outputs and final states;
* ``run(Experiment(replicas=3))`` for each metric, ``run_all`` with a
  folded seed axis and the CLI's ``run --replicas`` / ``sweep
  --replicas`` equal ``repro.api``'s records;
* a batched slot calls each crossbar kernel as often as a scalar one;
* ``resilience`` at 2 replicas is the scalar run of each seed; the
  refusal that stays (the ``switch`` axis over distinct devices) names
  its ROADMAP item, and a batched ``run_program(budget_chunks=)`` runs a
  bounded segment.

Tolerance: zero.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro.workloads as jax_wl
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.workloads as port_wl
from repro.api.cli import main as jax_cli_main
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.api.__main__ import main as cli_main
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.parallel.sharding import Mesh, Sharder
from repro_torch.simulator import engine as port_engine
from repro_torch.simulator.engine import (PROG_SHARED, SimConfig, Simulator,
                                          Traffic)

FABRICS = {
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0), "polarized"),
    "df": ("dragonfly", dict(a=4, p=2, h=2), "ugal"),
    "ft": ("fat_tree", dict(radix=4, h=1), "ksp"),
}
PATTERNS = {
    "uniform": dict(load=0.7),
    "rep": dict(load=0.7),
    "rsp": dict(load=0.7),
    "bursty": dict(load=0.5, burst_load=0.9, burst_len=4.0),
}
SEEDS = (0, 3, 5)
SLOTS = 14
MRLS = {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3,
                                     "seed": 0}}
ROUTE = {"policy": "polarized", "max_hops": 10, "pool": 4096}


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


def _port_sim(tables, fabric, pt=True):
    return Simulator(tables[fabric][1],
                     SimConfig(**_cfg(FABRICS[fabric][2]),
                               threefry_partitionable=pt), device="cpu")


def _jax_sim(tables, fabric):
    return JaxSimulator(tables[fabric][0], JaxConfig(**_cfg(
        FABRICS[fabric][2])))


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _program(pkg, S, schedule):
    """A Rabenseifner allreduce of 16 ranks of 8 packets (8 phases);
    window 2 under the ``window`` schedule."""
    return pkg.compile_program(pkg.rabenseifner_program(S, 16, 8),
                               schedule=schedule,
                               window=2 if schedule == "window" else 1)


# ---------------------------------------------------------------------- #
# batched states
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_make_batch_state_equals_reference(tables, fabric, pattern):
    with _jax_sim(tables, fabric) as jsim:
        want = jax.device_get(jsim.make_batch_state(
            JaxTraffic(pattern, **PATTERNS[pattern]), SEEDS))
    st = _port_sim(tables, fabric).make_batch_state(
        Traffic(pattern, **PATTERNS[pattern]), SEEDS)
    assert st["ejected"].shape == (len(SEEDS),)
    _assert_states_equal(state_to_numpy(st), want)


@pytest.mark.parametrize("schedule", ["barrier", "window"])
def test_make_program_batch_state_keeps_the_program_unstacked(tables,
                                                              schedule):
    sim = _port_sim(tables, "mrls")
    st = sim.make_program_batch_state(_program(port_wl, sim.S, schedule),
                                      SEEDS)
    with _jax_sim(tables, "mrls") as jsim:
        want = jax.device_get(jsim.make_program_batch_state(
            _program(jax_wl, sim.S, schedule), SEEDS))
    _assert_states_equal(state_to_numpy(st), want)
    for k, ndim in PROG_SHARED.items():
        assert st[k].ndim == ndim, k
    assert st["phase_done"].shape == (len(SEEDS), 8)
    # the round trip through the reference's layout keeps them unstacked
    back = state_from_jax(want, "cpu")
    _assert_states_equal(state_to_numpy(back), want)
    assert all(back[k].ndim == ndim for k, ndim in PROG_SHARED.items())


def test_empty_seed_list_is_refused(tables):
    sim = _port_sim(tables, "mrls")
    with pytest.raises(ValueError, match="at least one seed"):
        sim.make_batch_state(Traffic("uniform"), [])


# ---------------------------------------------------------------------- #
# the batched step, state for state
# ---------------------------------------------------------------------- #
# every fabric and pattern in the partitionable stream; in the original
# stream each pattern once, the fabrics in turn
CHUNK_CASES = ([(f, p, True) for f in FABRICS for p in PATTERNS]
               + [(f, p, False) for f, p in zip(
                   ("mrls", "df", "ft", "mrls"), PATTERNS)])


@pytest.mark.parametrize(
    "fabric,pattern,pt", CHUNK_CASES,
    ids=[f"{f}-{p}" + ("" if pt else "-original")
         for f, p, pt in CHUNK_CASES])
def test_run_chunk_batch_equals_reference(tables, fabric, pattern, pt):
    kw = PATTERNS[pattern]
    with jax.threefry_partitionable(pt), _jax_sim(tables, fabric) as jsim:
        tr = JaxTraffic(pattern, **kw)
        want = jax.device_get(jsim.run_chunk_batch(
            jsim.make_batch_state(tr, SEEDS), tr, SLOTS))
    sim = _port_sim(tables, fabric, pt)
    tr = Traffic(pattern, **kw)
    st = sim.run_chunk_batch(sim.make_batch_state(tr, SEEDS), tr, SLOTS)
    _assert_states_equal(state_to_numpy(st), want)
    assert (np.asarray(want["ejected"]) > 0).all()


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_each_replica_is_its_seeds_scalar_run(tables, fabric):
    sim = _port_sim(tables, fabric)
    tr = Traffic("rep", load=0.7)
    batch = state_to_numpy(sim.run_chunk(sim.make_batch_state(tr, SEEDS),
                                         tr, SLOTS))
    for i, seed in enumerate(SEEDS):
        one = state_to_numpy(sim.run_chunk(sim.make_state(tr, seed), tr,
                                           SLOTS))
        assert one["ejected"].ndim == 0
        _assert_states_equal({k: v[i] for k, v in batch.items()}, one)


def test_batched_step_calls_each_kernel_as_a_scalar_step(tables,
                                                         monkeypatch):
    """One step serves every replica: ``vc_prearb`` speedup + 1 calls and
    ``switch_arbitrate_rows`` speedup calls a slot, whatever R is."""
    calls = {"vc_prearb": 0, "switch_arbitrate_rows": 0}

    def counted(name):
        fn = getattr(port_engine, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call
    for name in calls:
        monkeypatch.setattr(port_engine, name, counted(name))
    sim = _port_sim(tables, "mrls")
    tr = Traffic("uniform", load=0.7)
    for seeds in ([0], [0, 1, 2, 3, 4]):
        for k in calls:
            calls[k] = 0
        sim.run_chunk(sim.make_batch_state(tr, seeds), tr, 3)
        speedup = sim.cfg.speedup
        assert calls == {"vc_prearb": 3 * (speedup + 1),
                         "switch_arbitrate_rows": 3 * speedup}, seeds


# ---------------------------------------------------------------------- #
# the batched measurement runs
# ---------------------------------------------------------------------- #
def _np_equal(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_run_throughput_batch_equals_reference(tables):
    with _jax_sim(tables, "df") as jsim:
        want = jsim.run_throughput_batch(JaxTraffic("uniform", load=0.8),
                                         SEEDS, warm=8, measure=12)
        want_st = jax.device_get(want["state"])
    sim = _port_sim(tables, "df")
    got = sim.run_throughput_batch(Traffic("uniform", load=0.8), SEEDS,
                                   warm=8, measure=12)
    _np_equal(got, want, ("throughput", "avg_hops", "ejected", "pool_stall"))
    assert got["throughput"].dtype == np.float64
    _assert_states_equal(state_to_numpy(got["state"]), want_st)
    for i, seed in enumerate(SEEDS):
        one = sim.run_throughput(Traffic("uniform", load=0.8), warm=8,
                                 measure=12, seed=seed)
        for k in ("throughput", "avg_hops", "ejected", "pool_stall"):
            assert one[k] == got[k][i], k


def test_run_latency_batch_equals_reference(tables):
    tr_kw = dict(load=0.5, elephant_frac=0.3, elephant_size=4)
    with _jax_sim(tables, "mrls") as jsim:
        want = jsim.run_latency_batch(JaxTraffic("mice_elephant", **tr_kw),
                                      SEEDS, warm=6, measure=16)
    sim = _port_sim(tables, "mrls")
    got = sim.run_latency_batch(Traffic("mice_elephant", **tr_kw), SEEDS,
                                warm=6, measure=16)
    assert set(got) == set(want)
    _np_equal(got, want, list(want))
    one = sim.run_latency(Traffic("mice_elephant", **tr_kw), warm=6,
                          measure=16, seed=SEEDS[1])
    assert {k: one[k] for k in want if k != "hist"} == {
        k: got[k][1] for k in want if k != "hist"}


@pytest.mark.parametrize("fabric", ["mrls", "ft"])
def test_batched_run_completion_equals_reference(tables, fabric):
    """An All2All of 3 rounds to completion: the run goes on until every
    replica is done; ``slots`` is each replica's own exact slot and the
    state and ``pool_stall`` are read where the last one finished."""
    with _jax_sim(tables, fabric) as jsim:
        tr = JaxTraffic("all2all", rounds=3)
        want = jsim.run_completion_batch(tr, expected=jsim.S * 3,
                                         seeds=SEEDS, chunk=4)
        want_st = jax.device_get(want["state"])
    sim = _port_sim(tables, fabric)
    tr = Traffic("all2all", rounds=3)
    got = sim.run_completion(tr, expected=sim.S * 3, chunk=4,
                             state=sim.make_batch_state(tr, SEEDS))
    _np_equal(got, want, ("slots", "completed", "pool_stall"))
    _assert_states_equal(state_to_numpy(got["state"]), want_st)
    for i, seed in enumerate(SEEDS):
        one = sim.run_completion(tr, expected=sim.S * 3, chunk=4, seed=seed)
        assert (one["slots"], one["completed"]) == (got["slots"][i],
                                                    got["completed"][i])


def test_batched_run_completion_stops_at_max_slots(tables):
    with _jax_sim(tables, "mrls") as jsim:
        tr = JaxTraffic("all2all", rounds=40)
        want = jsim.run_completion_batch(tr, expected=jsim.S * 40,
                                         seeds=SEEDS, chunk=4, max_slots=9)
    sim = _port_sim(tables, "mrls")
    got = sim.run_completion_batch(Traffic("all2all", rounds=40),
                                   expected=sim.S * 40, seeds=SEEDS,
                                   chunk=4, max_slots=9)
    _np_equal(got, want, ("slots", "completed", "pool_stall"))
    assert not got["completed"].any() and (got["slots"] == 12).all()


@pytest.mark.parametrize("schedule", ["barrier", "window"])
def test_run_program_seeds_equals_reference(tables, schedule):
    """``max_slots`` 10 forces some barrier phases across and leaves
    some window phases incomplete (they report the final slot)."""
    kw = dict(chunk=4, max_slots=10 if schedule == "window" else 40)
    with _jax_sim(tables, "mrls") as jsim:
        want = jsim.run_program(_program(jax_wl, jsim.S, schedule),
                                seeds=SEEDS, **kw)
        want_st = jax.device_get(want["state"])
    sim = _port_sim(tables, "mrls")
    cp = _program(port_wl, sim.S, schedule)
    got = sim.run_program(cp, seeds=SEEDS, **kw)
    _np_equal(got, want, ("slots", "completed", "pool_stall", "phase_slots"))
    _assert_states_equal(state_to_numpy(got["state"]), want_st)
    for i, seed in enumerate(SEEDS):
        one = sim.run_program(cp, seed=seed, **kw)
        assert one["slots"] == got["slots"][i]
        assert one["completed"] == got["completed"][i]
        np.testing.assert_array_equal(one["phase_slots"],
                                      got["phase_slots"][i])
    # a caller-built state with the program stacked runs the same
    st = sim.make_program_batch_state(cp, SEEDS)
    for k in PROG_SHARED:
        st[k] = st[k].expand((len(SEEDS),) + st[k].shape).contiguous()
    again = sim.run_program(cp, state=st, **kw)
    _np_equal(again, got, ("slots", "completed", "pool_stall",
                           "phase_slots"))


# ---------------------------------------------------------------------- #
# the runner, run_all's folding and the CLI
# ---------------------------------------------------------------------- #
def _exp(api, **kw):
    d = {"network": MRLS, "route": ROUTE, "warm": 8, "measure": 12}
    d.update(kw)
    return api.Experiment.from_dict(d)


RUN_CASES = {
    "throughput": dict(workload={"pattern": "rsp", "load": 0.8}),
    "latency": dict(workload={"pattern": "mice_elephant", "load": 0.5},
                    metric="latency"),
    "all2all": dict(workload={"pattern": "all2all", "rounds": 3}),
    "allreduce": dict(workload={"pattern": "allreduce", "ranks": 16,
                                "vec_packets": 4}),
    "a2a_window": dict(workload={"pattern": "all2all", "rounds": 4,
                                 "schedule": "window", "window": 2}),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_with_replicas_equals_reference(case):
    kw = dict(RUN_CASES[case], replicas=3, seed=2)
    want = jax_api.run(_exp(jax_api, **kw)).to_dict()
    got = port_api.run(_exp(port_api, **kw), device="cpu")
    assert got.to_dict() == want
    assert got.replica_seeds == (2, 3, 4)
    assert port_api.Result.from_json(got.to_json()) == got


def test_run_all_folds_seed_groups_as_reference(monkeypatch):
    from repro_torch.api import runner
    batches = []
    batched = runner._batched_metrics

    def spy(sim, exp, seeds):
        batches.append(list(seeds))
        return batched(sim, exp, seeds)
    monkeypatch.setattr(runner, "_batched_metrics", spy)
    exps = []
    for case in ("throughput", "latency", "allreduce"):
        exps += [dict(RUN_CASES[case], seed=s, name=f"{case}.s{s}")
                 for s in (1, 2)]
    exps.append(dict(RUN_CASES["all2all"], seed=7))
    want = [r.to_dict() for r in jax_api.run_all(
        [_exp(jax_api, **d) for d in exps])]
    got = port_api.run_all([_exp(port_api, **d) for d in exps],
                           device="cpu")
    assert [r.to_dict() for r in got] == want
    assert batches == [[1, 2]] * 3
    assert all(r.per_replica is None for r in got)


def test_cli_run_and_sweep_with_replicas_equal_reference(tmp_path, capsys):
    spec = tmp_path / "exps.json"
    spec.write_text(json.dumps({"experiments": [
        {"network": MRLS, "route": ROUTE, "warm": 8, "measure": 12,
         **RUN_CASES["throughput"]}]}))
    want_file, got_file = tmp_path / "want.json", tmp_path / "got.json"
    assert jax_cli_main(["run", str(spec), "--replicas", "2", "--seed", "3",
                         "--out", str(want_file)]) == 0
    capsys.readouterr()
    assert cli_main(["run", str(spec), "--replicas", "2", "--seed", "3",
                     "--device", "cpu", "--out", str(got_file)]) == 0
    printed = json.loads(capsys.readouterr().out)
    want = json.loads(want_file.read_text())
    assert printed == json.loads(got_file.read_text()) == want
    assert [r["replica_seeds"] for r in printed] == [[3, 4]]

    sweep_spec = tmp_path / "sweep.json"
    sweep_spec.write_text(json.dumps({
        "base": {"network": MRLS, "route": ROUTE, "warm": 8, "measure": 12,
                 "workload": {"pattern": "uniform", "load": 0.5},
                 "name": "cli"},
        "axes": {"workload.load": [0.5, 0.7]}}))
    assert jax_cli_main(["sweep", str(sweep_spec), "--replicas", "3",
                         "--out", str(want_file)]) == 0
    capsys.readouterr()
    assert cli_main(["sweep", str(sweep_spec), "--replicas", "3",
                     "--device", "cpu", "--out", str(got_file)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cli[workload.load=0.5]  metric=throughput  "
                               "replicas=3")
    assert json.loads(got_file.read_text()) == json.loads(
        want_file.read_text())


def test_refusals_that_stay_name_their_items(tables):
    # the resilience metric runs now (tests/test_torch_failures.py): its
    # replicas are scalar runs, each the run of its seed
    failures = port_core.FailureSchedule.random_links(
        port_core.mrls(**MRLS["params"]), 3, down_slot=4, up_slot=9,
        seed=1).to_dict()
    network = dict(MRLS, failures=failures)
    batched = port_api.run(_exp(port_api, network=network, replicas=2),
                           device="cpu")
    assert batched.metric == "resilience"
    assert batched.replica_seeds == (0, 1)
    for i, seed in enumerate(batched.replica_seeds):
        one = port_api.run(_exp(port_api, network=network, seed=seed),
                           device="cpu")
        assert one.throughput == batched.per_replica["throughput"][i]
        assert one.fail_drop == batched.per_replica["fail_drop"][i]
    sim = _port_sim(tables, "mrls")
    cp = _program(port_wl, sim.S, "barrier")
    # the bounded segment runs now (tests/test_torch_resilient.py)
    seg = sim.run_program(cp, seeds=SEEDS, budget_chunks=1)
    assert seg["running"] and seg["phase_slots"].shape == (len(SEEDS), 8)
    # the switch axis over distinct devices (a sharder's replica axis
    # runs: tests/test_torch_sharding.py); no card is touched
    distinct = Sharder.for_simulator(
        Mesh((torch.device("cpu"), torch.device("cuda", 0)), ("switch",)))
    with pytest.raises(NotImplementedError, match="item 16"):
        sim.shard_state(sim.make_state(Traffic("uniform")), distinct)
    with pytest.raises(ValueError, match="batched state"):
        sim.run_chunk_batch(sim.make_state(Traffic("uniform")),
                            Traffic("uniform"), 1)
