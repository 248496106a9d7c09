"""Failures in the port against the live reference: the schedules, the
delta table rebuild, the engine's live-mask branch, ``policy="degraded"``,
``run_resilience``, the runner's ``resilience`` metric, ``degrade_sweep``
and the CLI's ``degrade``.

On small fabrics (``mrls(14, 3, 3)``, ``dragonfly(4, 2, 2)``,
``fat_tree(4, 1)``; pool 4096), every case against the JAX package:

* ``FailureSchedule`` / ``FailureEvent``: the validators' exceptions and
  messages, JSON, ``transitions`` and the seeded constructors;
* ``RoutingTables.apply_failures``: every delta (rows, distances, mask
  words, liveness) and the tables after it, over a link ladder with its
  restore, switch events, duplicate and no-op events; ``hop_distances``
  over an effective adjacency with a dead switch against the BFS rows;
* ``degraded`` on a pristine fabric is ``minimal_adaptive`` state for
  state, and the reference's ``degraded``;
* an armed simulator with a schedule whose only event lies past the run
  replays ``tests/golden/torch_engine_parity_short.json`` value for
  value;
* ``run_resilience`` state for state with transitions in warm-up, at
  the warm boundary and in the window, under all six policies, in both
  threefry modes, with ``requeue`` and ``drop``; its Results, the
  restore of the pristine tables and the pool ledger;
* ``update_tables`` on a batched state, then batched slots;
* ``run`` with ``replicas=2``, ``run_all``'s folding, ``degrade_sweep``
  on ``examples/specs/tiny_faults.json`` and the CLI's ``degrade`` (its
  stdout and ``--out`` file);
* ``Simulator.dist`` is a copy, never a view, of the tables' rows.

Tolerance: zero.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro.api.cli import main as jax_cli_main
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.api.__main__ import main as cli_main
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.routing import hop_distances
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_FAULTS = ROOT / "examples" / "specs" / "tiny_faults.json"
SHORT_GOLDEN = ROOT / "tests" / "golden" / "torch_engine_parity_short.json"

FABRICS = {
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
    "df": ("dragonfly", dict(a=4, p=2, h=2)),
    "ft": ("fat_tree", dict(radix=4, h=1)),
}
# the fabric each policy runs on
POLICY_FABRIC = {"polarized": "mrls", "minimal_adaptive": "mrls",
                 "ksp": "ft", "degraded": "mrls", "ugal": "df",
                 "valiant": "df"}
WARM, MEASURE, SEED = 20, 30, 3
LOAD = 0.6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topo(core, fabric):
    fam, params = FABRICS[fabric]
    return getattr(core, fam)(**params)


def _schedule(core, topo, policy="requeue"):
    """A link ladder (down at 4, 10, 16 and 22, back at 30: warm-up and
    window), a link down at the warm boundary for good, and where the
    fabric has one, its first non-leaf switch down at 12 and up at 26."""
    ids = core.canonical_link_ids(topo)
    ladder = core.FailureSchedule.random_ladder(topo, 4, start_slot=4,
                                                step_slots=6, seed=2,
                                                up_slot=30).events
    used = {ev.id for ev in ladder}
    extra = next(int(i) for i in ids if int(i) not in used)
    events = list(ladder) + [core.FailureEvent("link", extra, WARM)]
    spines = np.nonzero(~topo.is_leaf)[0]
    if len(spines):
        events.append(core.FailureEvent("switch", int(spines[0]), 12, 26))
    return core.FailureSchedule(tuple(events), policy=policy)


def _assert_states_equal(got: dict, want: dict):
    got = state_to_numpy(got)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


# ---------------------------------------------------------------------- #
# schedules
# ---------------------------------------------------------------------- #
BAD_EVENTS = [dict(kind="port", id=0, down_slot=0),
              dict(kind="link", id=-1, down_slot=0),
              dict(kind="link", id=0, down_slot=-2),
              dict(kind="link", id=0, down_slot=5, up_slot=5),
              dict(kind="switch", id=1, down_slot=5, up_slot=2)]


@pytest.mark.parametrize("kw", BAD_EVENTS, ids=lambda kw: str(kw))
def test_event_validators_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jax_core.FailureEvent(**kw)
    with pytest.raises(ValueError, match=None) as got:
        port_core.FailureEvent(**kw)
    assert str(got.value) == str(want.value)


def test_schedule_policy_and_topology_checks_match_reference():
    errors = []
    for core in (jax_core, port_core):
        topo = _topo(core, "mrls")      # 42 ports without a link
        n, p = topo.n_switches, topo.max_ports
        unconnected = int(np.argwhere(topo.nbrs < 0)[0] @ [p, 1])
        leaf = int(topo.leaf_ids[0])
        msgs = []
        for make in (
                lambda: core.FailureSchedule(policy="lose"),
                lambda: core.FailureSchedule(
                    (core.FailureEvent("link", n * p, 0),)).validate(topo),
                lambda: core.FailureSchedule((core.FailureEvent(
                    "link", unconnected, 0),)).validate(topo),
                lambda: core.FailureSchedule(
                    (core.FailureEvent("switch", n, 0),)).validate(topo),
                lambda: core.FailureSchedule(
                    (core.FailureEvent("switch", leaf, 0),)).validate(topo),
                lambda: core.FailureSchedule.random_links(topo, 10 ** 6, 0),
                lambda: core.FailureSchedule.random_ladder(topo, 2, 0, 0)):
            with pytest.raises(ValueError) as e:
                make()
            msgs.append(str(e.value))
        errors.append(msgs)
    assert errors[0] == errors[1]


@pytest.mark.parametrize("fabric", FABRICS)
def test_schedule_json_transitions_and_constructors_match_reference(fabric):
    jt, pt = _topo(jax_core, fabric), _topo(port_core, fabric)
    np.testing.assert_array_equal(port_core.canonical_link_ids(pt),
                                  jax_core.canonical_link_ids(jt))
    for make in (lambda c, t: c.FailureSchedule.random_links(
                     t, 5, down_slot=3, up_slot=9, seed=4, policy="drop"),
                 lambda c, t: c.FailureSchedule.random_ladder(
                     t, 6, start_slot=2, step_slots=3, seed=1),
                 _schedule):
        want, got = make(jax_core, jt), make(port_core, pt)
        assert got.to_json() == want.to_json()
        assert got.to_dict() == want.to_dict()
        assert port_core.FailureSchedule.from_json(want.to_json()) == got
        assert len(got) == len(want)
        assert [(s, [e.to_dict() for e in d], [e.to_dict() for e in u])
                for s, d, u in got.transitions()] == [
            (s, [e.to_dict() for e in d], [e.to_dict() for e in u])
            for s, d, u in want.transitions()]
        assert got.validate(pt) is got


# ---------------------------------------------------------------------- #
# delta rebuilds
# ---------------------------------------------------------------------- #
def _steps(core, topo, kind):
    """The ``apply_failures`` calls of one scenario."""
    links = core.FailureSchedule.random_ladder(topo, 6, 0, 1, seed=1).events
    spines = np.nonzero(~topo.is_leaf)[0]
    if kind == "ladder":
        return [dict(down=links[:3]), dict(down=links[3:]),
                dict(up=links[:2]), dict(up=links[2:])]
    if kind == "switch":
        sw = [core.FailureEvent("switch", int(s), 0) for s in spines[:2]]
        return [dict(down=sw[:1]), dict(down=links[:2], up=()),
                dict(down=sw[1:], up=links[:1]), dict(up=sw),
                dict(up=links[1:2])]
    # duplicates and no-ops: a link downed twice (both directions named),
    # restores of live links, an empty call
    c, p = divmod(int(links[0].id), topo.max_ports)
    other = core.FailureEvent("link", int(topo.nbrs[c, p]) * topo.max_ports
                              + int(topo.nbr_port[c, p]), 0)
    return [dict(), dict(up=links[:2]), dict(down=(links[0], links[0])),
            dict(down=(other,)), dict(down=links[:1], up=links[:1]),
            dict(up=(other, links[1]))]


@pytest.mark.parametrize("kind", ("ladder", "switch", "dupes"))
@pytest.mark.parametrize("fabric", FABRICS)
def test_apply_failures_deltas_match_reference(fabric, kind):
    jt = jax_core.build_tables(_topo(jax_core, fabric))
    pt = port_core.build_tables(_topo(port_core, fabric), device="cpu")
    if kind == "switch" and not (~jt.topo.is_leaf).any():
        pytest.skip("every switch of this fabric is a leaf")  # DF: none
    pristine = pt.dist_leaf.clone()
    for step, kw in zip(_steps(jax_core, jt.topo, kind),
                        _steps(port_core, pt.topo, kind)):
        want, got = jt.apply_failures(**step), pt.apply_failures(**kw)
        np.testing.assert_array_equal(got.leaf_rows, want.leaf_rows)
        assert got.n_affected == want.n_affected and got.products == 0
        np.testing.assert_array_equal(got.dist_rows.numpy(), want.dist_rows)
        np.testing.assert_array_equal(
            got.min_rows.numpy().view(np.uint32), want.min_rows)
        np.testing.assert_array_equal(
            got.away_rows.numpy().view(np.uint32), want.away_rows)
        np.testing.assert_array_equal(got.link_up, want.link_up)
        np.testing.assert_array_equal(got.switch_up, want.switch_up)
        np.testing.assert_array_equal(pt.dist_leaf.numpy(), jt.dist_leaf)
        np.testing.assert_array_equal(pt.dead_ports, jt.dead_ports)
    if kind != "dupes":
        assert torch.equal(pt.dist_leaf, pristine)   # every step undone


def test_hop_distances_with_a_dead_switch_equal_the_bfs():
    """The card's rebuild path on the plain version: the effective
    adjacency stays symmetric, the dead switch's part of the graph is cut
    off, the stopping rule still stops, and ``UNREACHABLE`` fills the
    cut entries exactly where the BFS has none."""
    tables = port_core.build_tables(_topo(port_core, "ft"), device="cpu")
    topo = tables.topo
    spine = int(np.nonzero(~topo.is_leaf)[0][0])
    link = port_core.FailureSchedule.random_links(topo, 1, 0, seed=3).events
    delta = tables.apply_failures(down=(port_core.FailureEvent(
        "switch", spine, 0),) + link)
    eff = tables.effective_nbrs()
    assert (eff[spine] < 0).all() and not (eff == spine).any()
    adj = np.zeros((topo.n_switches,) * 2, bool)
    rows = np.repeat(np.arange(topo.n_switches), topo.max_ports)
    ok = eff.reshape(-1) >= 0
    adj[rows[ok], eff.reshape(-1)[ok]] = True
    assert (adj == adj.T).all()
    sources = topo.leaf_ids[delta.leaf_rows]
    got, _, products = hop_distances(eff, sources, "cpu")
    want = port_core.bfs_distances(topo, sources, nbrs=eff)
    np.testing.assert_array_equal(got.numpy(), want)
    assert products >= 1 and (want[:, spine] == -1).all()
    cut = torch.where(got < 0, port_core.UNREACHABLE, got)
    assert torch.equal(cut, delta.dist_rows)
    assert (delta.dist_rows[:, spine] == port_core.UNREACHABLE).all()


def test_simulator_distances_are_a_copy_of_the_tables():
    """``apply_failures`` rewrites the tables' rows in place; the
    simulator's pristine distances and masks must not follow (on the
    CPU the tables already hold int16 rows, where ``as_tensor`` alone
    would alias them)."""
    tables = port_core.build_tables(_topo(port_core, "mrls"), device="cpu")
    sim = Simulator(tables, SimConfig(policy="polarized"), device="cpu")
    dist0, min0 = sim.dist.clone(), sim.min_mask.clone()
    events = port_core.FailureSchedule.random_links(tables.topo, 8, 0,
                                                    seed=0).events
    delta = tables.apply_failures(down=events)
    assert delta.n_affected
    assert not torch.equal(tables.dist_leaf.reshape(-1), dist0)
    assert torch.equal(sim.dist, dist0)
    assert torch.equal(sim.min_mask, min0)
    tables.apply_failures(up=events)


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tables():
    """``{fabric: (reference tables, port tables)}``."""
    return {f: (jax_core.build_tables(_topo(jax_core, f)),
                port_core.build_tables(_topo(port_core, f), device="cpu"))
            for f in FABRICS}


def _cfg(policy):
    return dict(policy=policy, max_hops=10, pool=4096)


@pytest.fixture(scope="module")
def jax_sims(tables):
    """One armed reference simulator per (policy, threefry mode), shared
    by the cases (each case swaps its schedule in, as degrade_sweep
    does), so each compiles once."""
    sims = {}

    def get(policy, pt):
        key = (policy, pt)
        if key not in sims:
            jt = tables[POLICY_FABRIC[policy]][0]
            with jax.threefry_partitionable(pt):
                sims[key] = JaxSimulator(jt, JaxConfig(**_cfg(policy)),
                                         failures=_schedule(jax_core,
                                                            jt.topo))
        return sims[key]
    yield get
    for sim in sims.values():
        sim.close(clear=False)
    jax.clear_caches()


def _pool_ledger(st) -> int:
    return int(st["fl_len"]) + sum(int(np.asarray(st[k]).sum())
                                   for k in ("qlen", "oq_len", "eq_len"))


RES_KEYS = ("throughput", "avg_hops", "ejected", "pool_stall", "fail_drop",
            "p0.5", "p0.99", "p0.999", "p0.9999")


@pytest.mark.parametrize("fail_policy", ("requeue", "drop"))
@pytest.mark.parametrize("pt", (True, False),
                         ids=("partitionable", "original"))
@pytest.mark.parametrize("policy", list(POLICY_FABRIC))
def test_run_resilience_state_for_state(tables, jax_sims, policy, pt,
                                        fail_policy):
    fabric = POLICY_FABRIC[policy]
    jt, ptab = tables[fabric]
    sim = jax_sims(policy, pt)
    sim.failures = _schedule(jax_core, jt.topo, fail_policy)
    with jax.threefry_partitionable(pt):
        want = sim.run_resilience(JaxTraffic("uniform", load=LOAD),
                                  warm=WARM, measure=MEASURE, seed=SEED)
    want_st = jax.device_get(want["state"])
    port = Simulator(ptab, SimConfig(**_cfg(policy),
                                     threefry_partitionable=pt),
                     _schedule(port_core, ptab.topo, fail_policy),
                     device="cpu")
    pristine = ptab.dist_leaf.clone()
    got = port.run_resilience(Traffic("uniform", load=LOAD), warm=WARM,
                              measure=MEASURE, seed=SEED)
    _assert_states_equal(got["state"], want_st)
    for k in RES_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["hist"], want["hist"])
    assert torch.equal(ptab.dist_leaf, pristine)
    assert not ptab.dead_ports.any() and not ptab.dead_switches.any()
    assert _pool_ledger(got["state"]) == port.pool == _pool_ledger(want_st)
    if fail_policy == "drop":
        assert int(got["state"]["fail_drop"]) > 0


def test_degraded_on_a_pristine_fabric_is_minimal_adaptive(tables):
    jt, ptab = tables["mrls"]
    tr, slots = Traffic("uniform", load=0.8), 24
    states = []
    for policy in ("degraded", "minimal_adaptive"):
        sim = Simulator(ptab, SimConfig(**_cfg(policy)), device="cpu")
        st = sim.make_state(tr, seed=SEED)
        sim.run_chunk(st, tr, slots)
        states.append(state_to_numpy(st))
    for k in states[1]:
        np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
    with JaxSimulator(jt, JaxConfig(**_cfg("degraded"))) as ref:
        jtr = JaxTraffic("uniform", load=0.8)
        want = jax.device_get(ref.run_chunk(ref.make_state(jtr, seed=SEED),
                                            jtr, slots))
    for k in want:
        np.testing.assert_array_equal(states[0][k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("policy", ("polarized", "minimal_adaptive", "ksp",
                                    "ugal", "valiant"))
def test_armed_future_schedule_replays_the_short_golden(policy):
    """An armed simulator whose one event lies past the run steps through
    the state-resident tables and live masks all along: it must give the
    pristine golden's numbers value for value."""
    g = json.loads(SHORT_GOLDEN.read_text())
    gp = g["policies"][policy]
    ptab = port_core.build_tables(port_core.mrls(**g["fabric"]),
                                  device="cpu")
    far = port_core.FailureSchedule.random_links(ptab.topo, 1,
                                                 down_slot=10 ** 6)
    sim = Simulator(ptab, SimConfig(policy=policy, max_hops=10, pool=4096,
                                    threefry_partitionable=False), far,
                    device="cpu")
    assert sim.has_failures
    thr = sim.run_throughput(Traffic("uniform", load=0.7), warm=g["warm"],
                             measure=g["measure"])
    assert "tbl_min" in thr["state"]
    lat = sim.run_latency(Traffic("uniform", load=0.5), warm=g["warm"],
                          measure=g["measure"])
    assert (thr["throughput"], thr["avg_hops"], thr["ejected"],
            thr["pool_stall"]) == (gp["throughput"], gp["avg_hops"],
                                   gp["ejected"], gp["pool_stall"])
    assert {str(i): int(c) for i, c in enumerate(lat["hist"]) if c} \
        == gp["lat_hist_nonzero"]


def test_batched_update_tables_and_slots(tables):
    jt, ptab = tables["mrls"]
    seeds, policy = (0, 3), "degraded"
    jsched, psched = _schedule(jax_core, jt.topo), _schedule(port_core,
                                                             ptab.topo)
    tr, jtr = Traffic("uniform", load=LOAD), JaxTraffic("uniform", load=LOAD)
    ref = JaxSimulator(jt, JaxConfig(**_cfg(policy)), failures=jsched)
    port = Simulator(ptab, SimConfig(**_cfg(policy)), psched, device="cpu")
    want = ref.run_chunk_batch(ref.make_batch_state(jtr, seeds), jtr, 6)
    got = port.make_batch_state(tr, seeds)
    port.run_chunk_batch(got, tr, 6)
    scalar = port.make_state(tr, seeds[1])
    port.run_chunk(scalar, tr, 6)
    downs = [e for e in jsched.events if e.kind == "link"][:3]
    want = ref.update_tables(want, jt.apply_failures(down=downs))
    pdowns = [e for e in psched.events if e.kind == "link"][:3]
    delta = ptab.apply_failures(down=pdowns)
    assert delta.n_affected
    port.update_tables(got, delta)
    port.update_tables(scalar, delta)
    _assert_states_equal(got, jax.device_get(want))
    want = ref.run_chunk_batch(want, jtr, 8)
    port.run_chunk_batch(got, tr, 8)
    _assert_states_equal(got, jax.device_get(want))
    ref.close(clear=False)
    jt.apply_failures(up=downs)
    ptab.apply_failures(up=pdowns)
    # the round trip of an armed batched state through convert (the mask
    # words as uint32 there, int32 views here)
    arrays = state_to_numpy(got)
    assert arrays["tbl_min"].dtype == np.uint32
    back = state_to_numpy(state_from_jax(arrays, "cpu"))
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
    # and replica 1 of the batch is the scalar run of its seed
    port.run_chunk(scalar, tr, 8)
    one = state_to_numpy(scalar)
    for k, v in state_to_numpy(got).items():
        np.testing.assert_array_equal(v[1], one[k], err_msg=k)


def test_failure_refusals_match_reference(tables):
    jt, ptab = tables["mrls"]
    plain = Simulator(ptab, SimConfig(**_cfg("polarized")), device="cpu")
    ref = JaxSimulator(jt, JaxConfig(**_cfg("polarized")))
    tr = Traffic("uniform", load=LOAD)
    msgs = []
    for sim, t in ((ref, JaxTraffic("uniform", load=LOAD)), (plain, tr)):
        with pytest.raises(ValueError) as e:
            sim.run_resilience(t, warm=2, measure=2)
        with pytest.raises(RuntimeError) as r:
            sim.update_tables(sim.make_state(t), None)
        msgs.append((str(e.value), str(r.value)))
    ref.close(clear=False)
    assert msgs[0] == msgs[1]
    armed = Simulator(ptab, SimConfig(**_cfg("polarized")),
                      _schedule(port_core, ptab.topo), device="cpu")
    with pytest.raises(ValueError, match="scalar states"):
        armed.drop_dead_packets(armed.make_batch_state(tr, (0, 1)))
    with pytest.raises(ValueError, match="unknown policy"):
        Simulator(ptab, SimConfig(policy="shortest"), device="cpu")


# ---------------------------------------------------------------------- #
# the API and the CLI
# ---------------------------------------------------------------------- #
def _exp(api, **kw):
    topo = _topo(port_core, "mrls")
    d = {"network": {"family": "mrls",
                     "params": dict(FABRICS["mrls"][1]),
                     "failures": _schedule(port_core, topo,
                                           "drop").to_dict()},
         "route": {"policy": "degraded", "max_hops": 10, "pool": 4096},
         "workload": {"pattern": "uniform", "load": LOAD},
         "name": "faults.mrls14", "warm": WARM, "measure": MEASURE}
    d.update(kw)
    return api.Experiment.from_dict(d)


def test_specs_round_trip_and_resolve_resilience():
    for api in (jax_api, port_api):
        e = _exp(api)
        assert e.resolved_metric() == "resilience"
        assert api.Experiment.from_json(e.to_json()) == e
        assert e.network != api.NetworkSpec(e.network.family,
                                            e.network.params)
        empty = dict(e.network.to_dict(), failures={"events": []})
        assert api.Experiment.from_dict(dict(
            e.to_dict(), network=empty)).resolved_metric() == "throughput"
    assert _exp(port_api).to_dict() == _exp(jax_api).to_dict()


@pytest.mark.parametrize("replicas", (1, 2))
def test_run_resilience_results_match_reference(replicas):
    want = jax_api.run(_exp(jax_api, replicas=replicas)).to_dict()
    got = port_api.run(_exp(port_api, replicas=replicas),
                       device="cpu").to_dict()
    assert got == want
    assert got["metric"] == "resilience"


def test_run_all_folds_resilience_seeds_as_reference():
    exps = [_exp(jax_api, seed=s, name=f"f{s}") for s in (0, 1)]
    want = [r.to_dict() for r in jax_api.run_all(exps)]
    got = [r.to_dict() for r in port_api.run_all(
        [_exp(port_api, seed=s, name=f"f{s}") for s in (0, 1)],
        device="cpu")]
    assert got == want


def test_degrade_sweep_matches_reference():
    spec = json.loads(TINY_FAULTS.read_text())
    want = jax_api.degrade_sweep(jax_api.DegradeSpec.from_dict(spec))
    got = port_api.degrade_sweep(port_api.DegradeSpec.from_dict(spec),
                                 device="cpu")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert port_api.DegradeSpec.from_dict(spec).to_dict() == \
        jax_api.DegradeSpec.from_dict(spec).to_dict()
    with pytest.raises(ValueError, match=r"rates must lie in \[0, 1\)"):
        port_api.DegradeSpec.from_dict(dict(spec, rates=[1.0]))


def test_cli_degrade_matches_reference(tmp_path, capsys):
    doc = json.loads(TINY_FAULTS.read_text())
    spec = tmp_path / "faults.json"
    spec.write_text(json.dumps({"sweeps": [
        dict(doc, rates=[0.0, 0.1], fail_policy="drop")]}))
    want_file, got_file = tmp_path / "want.json", tmp_path / "got.json"
    assert jax_cli_main(["degrade", str(spec), "--seed", "2", "--out",
                         str(want_file)]) == 0
    want = capsys.readouterr().out.replace(str(want_file), "OUT")
    assert cli_main(["degrade", str(spec), "--seed", "2", "--device", "cpu",
                     "--out", str(got_file)]) == 0
    got = capsys.readouterr().out.replace(str(got_file), "OUT")
    assert got == want
    assert got_file.read_text() == want_file.read_text()
