"""The port's resumable runtime against the live reference: the engine's
bounded segments, ``Checkpointer``, the resumable runs, and the
fault-tolerance layer.

On ``mrls(14, 3, 3, seed=0)`` (Polarized, ``max_hops`` 10, pool 4096),
every case against the JAX package:

* bounded ``run_completion`` and ``run_program`` (scalar and two
  replicas; ``barrier`` and ``window``) chained over B = 1, 2, 3 chunks:
  each segment's ``running``, ``done`` and state equal the reference's
  bounded call, and the chain's end equals one unbounded call;
* ``run_program_resumable``, ``run_completion_resumable`` and
  ``run_window_resumable`` (throughput, latency, serving; scalar and
  batched): the result equals the reference's, and every segment's
  snapshot equals the reference's snapshot of the same segment (the
  port's layout mapped: index ``pool`` of the four pool arrays dropped,
  the key and mask words viewed as uint32), ``meta.json`` field for
  field;
* a resume from a middle snapshot equals the uninterrupted run;
* the fingerprint-mismatch refusal with the reference's message;
* ``Checkpointer``: files written by either package read by the other
  (int16, int32, bool, float32, bfloat16), an armed state's round trip
  (tables, live masks, ``bool`` entries), a snapshot that does not alias
  a state the engine advances in place, retention and stale ``tmp.*``;
* ``BackoffPolicy.delay`` bit for bit over a grid, ``StragglerDetector``
  and ``FaultTolerantRunner``'s transient and wedge cases against the
  reference's, and ``schedule_fault_hook`` driving an armed simulator to
  the reference's final state.

Tolerance: zero.
"""
import json
import math
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.workloads as jax_wl
import repro_torch.core as port_core
import repro_torch.workloads as port_wl
from repro.checkpointing.checkpoint import Checkpointer as JaxCheckpointer
from repro.runtime import fault_tolerance as jax_ft
from repro.runtime import resilient as jax_res
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.checkpointing import Checkpointer
from repro_torch.convert import state_to_numpy
from repro_torch.models.common import ParamSpec
from repro_torch.parallel.sharding import Mesh, Sharder
from repro_torch.runtime import fault_tolerance as port_ft
from repro_torch.runtime import resilient as port_res
from repro_torch.simulator.engine import (KEY_KEYS, MASK_KEYS, POOL_KEYS,
                                          SimConfig, Simulator, Traffic)

MRLS = dict(n_leaves=14, u=3, d=3, seed=0)
CFG = dict(policy="polarized", max_hops=10, pool=4096)
SEEDS = [0, 3]
A2A = dict(pattern="all2all", rounds=4)
# the windowed metrics' traffic
WINDOW_TRAFFIC = {
    "throughput": dict(pattern="uniform", load=0.5),
    "latency": dict(pattern="bursty", load=0.4, burst_len=4.0,
                    burst_load=0.9),
    "serving": dict(pattern="arrival", process="pareto", load=0.5,
                    pareto_alpha=1.5, pareto_cap=16),
}


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
def sims():
    """``(reference simulator, port simulator)`` of the golden fabric."""
    js = JaxSimulator(jax_core.build_tables(jax_core.mrls(**MRLS)),
                      JaxConfig(**CFG))
    ps = Simulator(port_core.build_tables(port_core.mrls(**MRLS),
                                          device="cpu"),
                   SimConfig(**CFG), device="cpu")
    yield js, ps
    js.close()


def _programs(schedule):
    """A Rabenseifner allreduce of 16 ranks of 8 packets in both packages;
    window 2 under ``window``."""
    window = 2 if schedule == "window" else 1
    return tuple(pkg.compile_program(pkg.rabenseifner_program(42, 16, 8),
                                     schedule=schedule, window=window)
                 for pkg in (jax_wl, port_wl))


def _assert_states_equal(port_state: dict, jax_state: dict):
    got = state_to_numpy(port_state)
    want = jax.device_get(jax_state)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


def _as_reference(path: str, a: np.ndarray) -> np.ndarray:
    """A snapshot entry of the port in the reference's layout."""
    k = path.rsplit("/", 1)[-1]
    if path.startswith("state/"):
        if k in KEY_KEYS or k in MASK_KEYS:
            return a.view(np.uint32)
        if k in POOL_KEYS:
            return a[..., :-1]
    return a


def _assert_snapshots_equal(port_dir, jax_dir) -> int:
    """Every ``step_*`` of the two directories equal under the mapping,
    arrays and ``meta.json``; returns the number of snapshots."""
    port_dir, jax_dir = pathlib.Path(port_dir), pathlib.Path(jax_dir)
    names = sorted(p.name for p in port_dir.glob("step_*"))
    assert names and names == sorted(p.name for p in jax_dir.glob("step_*"))
    for name in names:
        with np.load(port_dir / name / "arrays.npz") as a, \
                np.load(jax_dir / name / "arrays.npz") as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in b.files:
                got, want = _as_reference(k, a[k]), b[k]
                assert got.dtype == want.dtype, (name, k)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name}: {k}")
        metas = [json.loads((d / name / "meta.json").read_text())
                 for d in (port_dir, jax_dir)]
        assert metas[0] == metas[1], name
    return len(names)


def _equal_results(got: dict, want: dict, keys):
    for k in keys:
        g, w = got[k], want[k]
        if w is None or isinstance(w, bool):
            assert g is w, k
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)


# ---------------------------------------------------------------------- #
# bounded segments
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("budget", [1, 2, 3])
@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "r2"])
def test_bounded_completion_chain_equals_reference_and_unbounded(
        sims, batched, budget):
    js, ps = sims
    kw = dict(chunk=2, max_slots=400)
    expected = ps.S * A2A["rounds"]
    jst = (js.make_batch_state(JaxTraffic(**A2A), SEEDS) if batched
           else js.make_state(JaxTraffic(**A2A), 0))
    pst = (ps.make_batch_state(Traffic(**A2A), SEEDS) if batched
           else ps.make_state(Traffic(**A2A), 0))
    jdone = pdone = None
    segments = 0
    while True:
        jr = js.run_completion(JaxTraffic(**A2A), expected, state=jst,
                               budget_chunks=budget, done=jdone, **kw)
        pr = ps.run_completion(Traffic(**A2A), expected, state=pst,
                               budget_chunks=budget, done=pdone, **kw)
        jst, jdone, pst, pdone = jr["state"], jr["done"], pr["state"], \
            pr["done"]
        segments += 1
        assert pr["running"] == jr["running"]
        assert isinstance(pdone, np.ndarray) and pdone.dtype == np.int32
        np.testing.assert_array_equal(pdone, np.asarray(jdone))
        assert pdone.shape == np.asarray(jdone).shape
        _assert_states_equal(pst, jst)
        if not pr["running"]:
            break
    assert segments > 1
    one = ps.run_completion(
        Traffic(**A2A), expected,
        state=(ps.make_batch_state(Traffic(**A2A), SEEDS) if batched
               else ps.make_state(Traffic(**A2A), 0)), **kw)
    _equal_results(pr, one, ("slots", "completed", "pool_stall"))
    _equal_results(pr, jr, ("slots", "completed", "pool_stall"))
    _assert_states_equal(one["state"], jst)


def test_bounded_completion_stops_at_max_slots(sims):
    _, ps = sims
    r = ps.run_completion(Traffic(**A2A), 10 ** 6, chunk=4, max_slots=8,
                          seed=0, budget_chunks=5)
    assert r["running"] is False and r["slots"] == 8
    assert not r["completed"] and r["done"].shape == ()


@pytest.mark.parametrize("budget", [1, 2, 3])
@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "r2"])
@pytest.mark.parametrize("schedule", ["barrier", "window"])
def test_bounded_program_chain_equals_reference_and_unbounded(
        sims, schedule, batched, budget):
    js, ps = sims
    jp, pp = _programs(schedule)
    kw = dict(chunk=4, max_slots=400)
    jst = (js.make_program_batch_state(jp, SEEDS) if batched
           else js.make_program_state(jp, 0))
    pst = (ps.make_program_batch_state(pp, SEEDS) if batched
           else ps.make_program_state(pp, 0))
    segments = 0
    while True:
        jr = js.run_program(jp, state=jst, budget_chunks=budget, **kw)
        pr = ps.run_program(pp, state=pst, budget_chunks=budget, **kw)
        jst, pst = jr["state"], pr["state"]
        segments += 1
        assert pr["running"] == jr["running"]
        _equal_results(pr, jr, ("slots", "completed", "pool_stall",
                                "phase_slots"))
        _assert_states_equal(pst, jst)
        if not pr["running"]:
            break
    assert segments > 1
    one = ps.run_program(pp, seeds=SEEDS if batched else None, **kw)
    _equal_results(pr, one, ("slots", "completed", "pool_stall",
                             "phase_slots"))
    _assert_states_equal(one["state"], jst)


# ---------------------------------------------------------------------- #
# resumable runs, snapshot for snapshot
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "r2"])
@pytest.mark.parametrize("schedule", ["barrier", "window"])
def test_program_resumable_snapshots_equal_reference(sims, tmp_path,
                                                     schedule, batched):
    js, ps = sims
    jp, pp = _programs(schedule)
    kw = dict(chunk=4, max_slots=400, seed=0,
              seeds=SEEDS if batched else None)
    want = jax_res.run_program_resumable(
        js, jp, ckpt=str(tmp_path / "jax"),
        config=jax_res.ResilientConfig(every=2, keep=100), **kw)
    got = port_res.run_program_resumable(
        ps, pp, ckpt=str(tmp_path / "port"),
        config=port_res.ResilientConfig(every=2, keep=100), **kw)
    _equal_results(got, want, ("slots", "completed", "pool_stall",
                               "phase_slots", "segments", "resumed_from",
                               "running"))
    _assert_states_equal(got["state"], want["state"])
    assert _assert_snapshots_equal(tmp_path / "port",
                                   tmp_path / "jax") == got["segments"] > 1


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "r2"])
def test_completion_resumable_snapshots_equal_reference(sims, tmp_path,
                                                        batched):
    js, ps = sims
    kw = dict(chunk=2, max_slots=400, seed=0,
              seeds=SEEDS if batched else None)
    expected = ps.S * A2A["rounds"]
    want = jax_res.run_completion_resumable(
        js, JaxTraffic(**A2A), expected, ckpt=str(tmp_path / "jax"),
        config=jax_res.ResilientConfig(every=1, keep=100), **kw)
    got = port_res.run_completion_resumable(
        ps, Traffic(**A2A), expected, ckpt=str(tmp_path / "port"),
        config=port_res.ResilientConfig(every=1, keep=100), **kw)
    _equal_results(got, want, ("slots", "completed", "pool_stall", "done",
                               "segments", "resumed_from", "running"))
    _assert_states_equal(got["state"], want["state"])
    assert _assert_snapshots_equal(tmp_path / "port",
                                   tmp_path / "jax") == got["segments"] > 1


_WINDOW_KEYS = {
    "throughput": ("throughput", "avg_hops", "ejected", "pool_stall"),
    "latency": ("hist", "p0.5", "p0.99", "p0.999", "p0.9999"),
    "serving": ("hist", "offered", "delivered", "dropped", "pool_stall",
                "p0.5", "p0.99", "p0.999", "p0.9999"),
}


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "r2"])
@pytest.mark.parametrize("metric", sorted(WINDOW_TRAFFIC))
def test_window_resumable_snapshots_equal_reference(sims, tmp_path, metric,
                                                    batched):
    js, ps = sims
    kw = dict(warm=10, measure=17, seed=2, seeds=SEEDS if batched else None)
    tr = WINDOW_TRAFFIC[metric]
    want = jax_res.run_window_resumable(
        js, JaxTraffic(**tr), metric=metric, ckpt=str(tmp_path / "jax"),
        config=jax_res.ResilientConfig(every=4, keep=100), **kw)
    got = port_res.run_window_resumable(
        ps, Traffic(**tr), metric=metric, ckpt=str(tmp_path / "port"),
        config=port_res.ResilientConfig(every=4, keep=100), **kw)
    _equal_results(got, want, _WINDOW_KEYS[metric]
                   + ("segments", "resumed_from"))
    _assert_states_equal(got["state"], want["state"])
    # 10 warm slots in 4 + 4 + 2, the base at the boundary, 17 in 5 segments
    assert _assert_snapshots_equal(tmp_path / "port",
                                   tmp_path / "jax") == got["segments"] == 8
    # and the one-shot run's numbers
    one = getattr(ps, f"run_{metric}" + ("_batch" if batched else ""))
    ref = (one(Traffic(**tr), SEEDS, warm=10, measure=17) if batched
           else one(Traffic(**tr), warm=10, measure=17, seed=2))
    _equal_results(got, ref, _WINDOW_KEYS[metric])


def _drop_after(ckpt: pathlib.Path, step: int) -> None:
    """What a kill after snapshot ``step`` leaves: no later snapshot."""
    for d in ckpt.glob("step_*"):
        if int(d.name[5:]) > step:
            shutil.rmtree(d)


@pytest.mark.parametrize("kind", ["program", "completion", "serving"])
def test_resume_from_a_middle_snapshot_equals_the_uninterrupted_run(
        sims, tmp_path, kind):
    _, ps = sims
    cfg = port_res.ResilientConfig(every=1, keep=100)
    if kind == "program":
        pp = _programs("barrier")[1]

        def go():
            return port_res.run_program_resumable(
                ps, pp, ckpt=str(tmp_path), chunk=4, max_slots=400,
                config=cfg)
        keys = ("slots", "completed", "pool_stall", "phase_slots")
    elif kind == "completion":
        def go():
            return port_res.run_completion_resumable(
                ps, Traffic(**A2A), ps.S * 4, ckpt=str(tmp_path), chunk=2,
                max_slots=400, seeds=SEEDS, config=cfg)
        keys = ("slots", "completed", "pool_stall", "done")
    else:
        cfg = port_res.ResilientConfig(every=3, keep=100)

        def go():
            return port_res.run_window_resumable(
                ps, Traffic(**WINDOW_TRAFFIC["serving"]), metric="serving",
                ckpt=str(tmp_path), warm=7, measure=11, seed=1, config=cfg)
        keys = _WINDOW_KEYS["serving"]
    full = go()
    assert full["resumed_from"] is None and full["segments"] >= 3
    mid = full["segments"] // 2
    _drop_after(tmp_path, mid)
    again = go()
    assert again["resumed_from"] == mid
    assert again["segments"] == full["segments"]
    _equal_results(again, full, keys)
    for k, v in full["state"].items():
        assert torch.equal(again["state"][k], v), k


def test_fingerprint_mismatch_refused_with_the_reference_message(sims,
                                                                   tmp_path):
    js, ps = sims
    jp, pp = _programs("barrier")
    msgs = []
    for name, sim, prog, res in (("jax", js, jp, jax_res),
                                 ("port", ps, pp, port_res)):
        ckpt = str(tmp_path / name)
        res.run_program_resumable(sim, prog, ckpt=ckpt, chunk=4,
                                  max_slots=400,
                                  config=res.ResilientConfig(every=2))
        with pytest.raises(ValueError,
                           match="different run configuration") as e:
            res.run_program_resumable(sim, prog, ckpt=ckpt, chunk=8,
                                      max_slots=400,
                                      config=res.ResilientConfig(every=2))
        msgs.append(str(e.value).replace(ckpt, "<dir>"))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="every must be >= 1"):
        port_res.ResilientConfig(every=0)
    with pytest.raises(ValueError, match="supports throughput"):
        port_res.run_window_resumable(ps, Traffic("uniform"),
                                      metric="completion",
                                      ckpt=str(tmp_path / "w"))
    with pytest.raises(ValueError, match="serving needs"):
        port_res.run_window_resumable(ps, Traffic("uniform"),
                                      metric="serving",
                                      ckpt=str(tmp_path / "w"))


# ---------------------------------------------------------------------- #
# Checkpointer
# ---------------------------------------------------------------------- #
def _port_tree():
    g = torch.Generator().manual_seed(5)
    return {"state": {"d": torch.arange(-6, 6, dtype=torch.int16),
                      "i": torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 4),
                                         dtype=torch.int32, generator=g),
                      "ok": torch.tensor([True, False, True])},
            "w": [torch.randn(5, generator=g),
                  (torch.randn(7, generator=g) * 3).to(torch.bfloat16)]}


def test_port_checkpoint_is_read_by_the_reference(tmp_path):
    tree = _port_tree()
    Checkpointer(str(tmp_path)).save(4, tree, meta={"note": "x"})
    template = {"state": {"d": np.zeros(12, np.int16),
                          "i": np.zeros((3, 4), np.int32),
                          "ok": np.zeros(3, bool)},
                "w": [np.zeros(5, np.float32),
                      jnp.zeros(7, jnp.bfloat16)]}
    got, meta = JaxCheckpointer(str(tmp_path)).restore(template, 4)
    assert meta == {"dtypes": {"w/1": "bfloat16"}, "step": 4, "note": "x"}
    for want, have in ((tree["state"]["d"], got["state"]["d"]),
                       (tree["state"]["i"], got["state"]["i"]),
                       (tree["state"]["ok"], got["state"]["ok"]),
                       (tree["w"][0], got["w"][0])):
        assert have.dtype == want.numpy().dtype
        np.testing.assert_array_equal(have, want.numpy())
    assert np.asarray(got["w"][1]).dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["w"][1]).view(np.uint16),
        tree["w"][1].view(torch.int16).numpy().view(np.uint16))


def test_reference_checkpoint_is_read_by_the_port(tmp_path):
    tree = _port_tree()
    host = {"state": {k: v.numpy() for k, v in tree["state"].items()},
            "w": [tree["w"][0].numpy(),
                  jnp.asarray(tree["w"][1].float().numpy(), jnp.bfloat16)]}
    JaxCheckpointer(str(tmp_path)).save(2, host)
    template = {"state": {k: torch.zeros_like(v)
                          for k, v in tree["state"].items()},
                "w": [torch.zeros(5), torch.zeros(7, dtype=torch.bfloat16)]}
    got, meta = Checkpointer(str(tmp_path)).restore(template)
    assert meta["step"] == 2 and meta["dtypes"] == {"w/1": "bfloat16"}
    for k, v in tree["state"].items():
        t = got["state"][k]
        assert t.dtype == v.dtype and t.is_contiguous(), k
        assert torch.equal(t, v), k
    assert torch.equal(got["w"][0], tree["w"][0])
    assert got["w"][1].dtype == torch.bfloat16
    assert torch.equal(got["w"][1].view(torch.int16),
                       tree["w"][1].view(torch.int16))
    with pytest.raises(KeyError, match="checkpoint missing state/nope"):
        Checkpointer(str(tmp_path)).restore(
            {"state": {"nope": torch.zeros(1)}})


def test_armed_state_checkpoint_roundtrip(tmp_path):
    topo = port_core.mrls(**MRLS)
    sched = port_core.FailureSchedule.random_links(topo, 2, down_slot=3,
                                                   seed=0)
    tables = port_core.build_tables(topo, device="cpu")
    s = Simulator(tables, SimConfig(**CFG), failures=sched, device="cpu")
    tr = Traffic("all2all", rounds=2)
    st = s.make_state(tr, 0)
    for _ in range(2):     # 3 slots, the links go down at 3, 3 more
        s.run_chunk(st, tr, 3)
        if _ == 0:
            s.update_tables(st, tables.apply_failures(down=sched.events))
    assert st["tbl_dist"].dtype == torch.int16
    assert st["link_up"].dtype == torch.bool
    assert not bool(st["link_up"].all())
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"state": st})
    saved = {k: v.clone() for k, v in st.items()}
    s.run_chunk(st, tr, 4)          # in place, after the save
    template = {"state": s.make_state(tr, 0)}
    got, meta = ck.restore(template, 1)
    assert meta == {"dtypes": {}, "step": 1}
    assert list(got["state"]) == list(template["state"])
    for k, v in saved.items():
        assert got["state"][k].dtype == v.dtype, k
        assert torch.equal(got["state"][k], v), k
    # the step wrote into the saved state's tensors after the save
    assert [k for k in ("fl_buf", "p_sd", "p_bh", "lat_hist")
            if not torch.equal(saved[k], st[k])]
    tables.apply_failures(up=sched.events)


def test_save_async_copies_before_it_returns(tmp_path):
    x = torch.arange(6, dtype=torch.int32)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, {"x": x})
    x.add_(100)                       # what the engine's in-place step does
    ck.wait()
    got, _ = ck.restore({"x": torch.zeros(6, dtype=torch.int32)})
    assert got["x"].tolist() == list(range(6))


def test_retention_and_stale_tmp(tmp_path):
    (tmp_path / "tmp.9").mkdir()
    (tmp_path / "tmp.9" / "arrays.npz").write_bytes(b"partial")
    ck = Checkpointer(str(tmp_path), keep=2)
    assert not (tmp_path / "tmp.9").exists()
    for step in (1, 2, 3):
        ck.save(step, {"a": torch.full((2,), step)})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got, meta = ck.restore({"a": torch.zeros(2, dtype=torch.int64)}, 2)
    assert got["a"].tolist() == [2, 2] and meta["step"] == 2
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Checkpointer(str(tmp_path / "empty")).restore({"a": torch.zeros(1)})


# ---------------------------------------------------------------------- #
# fault tolerance
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("jitter", [0.0, 0.1, 0.35])
def test_backoff_delay_equals_reference_bit_for_bit(jitter, seed):
    kw = dict(base_s=0.25, factor=3.0, cap_s=20.0, jitter=jitter, seed=seed)
    want, got = jax_ft.BackoffPolicy(**kw), port_ft.BackoffPolicy(**kw)
    for consecutive in range(0, 8):
        for total in range(0, 12):
            assert got.delay(consecutive, total) == \
                want.delay(consecutive, total)


def test_backoff_deterministic_and_bounded():
    p = port_ft.BackoffPolicy(base_s=0.5, factor=2.0, cap_s=30.0, jitter=0.1)
    assert p.delay(2, 5) == p.delay(2, 5)
    assert p.delay(2, 5) != p.delay(2, 6)
    for consecutive in (1, 2, 3, 7):
        nominal = min(0.5 * 2.0 ** (consecutive - 1), 30.0)
        assert nominal * 0.9 <= p.delay(consecutive, 1) <= nominal * 1.1
    assert p.delay(40, 1) <= 30.0 * 1.1
    q = port_ft.BackoffPolicy(base_s=1.0, factor=2.0, cap_s=8.0, jitter=0.0)
    assert [q.delay(c, c) for c in (1, 2, 3, 4, 5)] == [1, 2, 4, 8, 8]


def test_straggler_detector_equals_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 4.0, 1.0, 1.2, 7.5, 1.0, 1.0]
    dets = [pkg.StragglerDetector(pkg.FTConfig(straggler_z=2.5, ema=0.8))
            for pkg in (jax_ft, port_ft)]
    for i, dt in enumerate(times):
        assert dets[0].observe(i, dt) == dets[1].observe(i, dt)
        assert (dets[0].mean, dets[0].var, dets[0].n) == \
            (dets[1].mean, dets[1].var, dets[1].n)
    assert dets[1].flagged == dets[0].flagged == [(6, 4.0), (9, 7.5)]


def _counting_runners(tmp_path, fail_steps, cfg_kw, wedge=False):
    """Both packages' runners on ``s + batch`` with faults injected
    before ``fail_steps`` (every attempt at them if ``wedge``)."""
    out = []
    for name, ft, ck, num in (
            ("jax", jax_ft, JaxCheckpointer, jnp),
            ("port", port_ft, Checkpointer, torch)):
        fired = set()

        def hook(step, fired=fired):
            if step in fail_steps and (wedge or step not in fired):
                fired.add(step)
                raise RuntimeError(f"injected @ {step}")

        slept = []
        run = ft.FaultTolerantRunner(
            lambda s, b, num=num: (s + b["x"],
                                   {"loss": num.tensor(1.0)
                                    if num is torch else num.float32(1.0)}),
            lambda s, num=num: {"x": num.tensor(float(s))
                                if num is torch else num.float32(s)},
            ck(str(tmp_path / name)), ft.FTConfig(**cfg_kw),
            fault_hook=hook, sleep_fn=slept.append)
        out.append((run, slept))
    return out


def test_runner_scattered_transients_survive(tmp_path):
    cfg = dict(ckpt_every=2, max_retries=5, max_consecutive=1)
    (jr, jslept), (pr, pslept) = _counting_runners(tmp_path, {5, 9, 13},
                                                   cfg)
    jstate, jstep, jhist = jr.run(jnp.float32(0.0), 0, 16)
    pstate, pstep, phist = pr.run(torch.tensor(0.0), 0, 16)
    assert pstep == jstep == 16
    assert float(pstate) == float(jstate) == sum(range(16))
    assert phist == jhist
    assert (pr.total_failures, pr.consecutive_failures, pr.restarts) == \
        (jr.total_failures, jr.consecutive_failures, jr.restarts) == (3, 0, 3)
    assert pr.delays == jr.delays == pslept == jslept
    assert pr.delays == [port_ft.FTConfig().backoff.delay(1, t)
                         for t in (1, 2, 3)]


def test_runner_hard_wedge_fails_fast(tmp_path):
    cfg = dict(ckpt_every=2, max_retries=50, max_consecutive=2)
    (jr, _), (pr, _) = _counting_runners(tmp_path, {4}, cfg, wedge=True)
    with pytest.raises(RuntimeError, match="injected @ 4"):
        jr.run(jnp.float32(0.0), 0, 10)
    with pytest.raises(RuntimeError, match="injected @ 4"):
        pr.run(torch.tensor(0.0), 0, 10)
    assert pr.consecutive_failures == jr.consecutive_failures == 3
    assert pr.total_failures == jr.total_failures == 3


def test_runner_restores_a_non_finite_loss_onto_the_device(tmp_path):
    losses = iter([1.0, 1.0, float("nan"), 1.0, 1.0, 1.0])
    run = port_ft.FaultTolerantRunner(
        lambda s, b: (s + 1, {"loss": torch.tensor(next(losses))}),
        lambda s: None, Checkpointer(str(tmp_path)),
        port_ft.FTConfig(ckpt_every=1), device="cpu",
        sleep_fn=lambda d: None)
    state, step, hist = run.run(torch.zeros(2, dtype=torch.int32), 0, 4)
    assert step == 4 and state.tolist() == [4, 4]
    assert run.total_failures == 1 and len(hist) == 4
    # a leaf split over distinct devices stays refused (a split over
    # one device runs: tests/test_torch_sharding.py); no card is touched
    mesh = Mesh((torch.device("cpu"), torch.device("cuda", 0)),
                ("data", "model"), (1, 2))
    with pytest.raises(NotImplementedError, match="item 16"):
        port_ft.elastic_reshard(
            {"a": state}, Sharder(mesh),
            {"a": ParamSpec((2,), "int32", axes=("tp",))})


def test_schedule_fault_hook_reaches_the_reference_state(tmp_path):
    """Both packages' runners drive an armed simulator two slots a step,
    a ``drop`` ladder's transitions applied by the hook on the step
    clock; the final states are equal."""
    finals = []
    for name, core, sim_cls, cfg_cls, tr_cls, ft, ck_cls in (
            ("jax", jax_core, JaxSimulator, JaxConfig, JaxTraffic, jax_ft,
             JaxCheckpointer),
            ("port", port_core, Simulator, SimConfig, Traffic, port_ft,
             Checkpointer)):
        topo = core.mrls(**MRLS)
        ladder = core.FailureSchedule.random_ladder(
            topo, 3, start_slot=3, step_slots=4, seed=1, up_slot=14)
        sched = core.FailureSchedule(ladder.events, policy="drop")
        kw = {} if name == "jax" else {"device": "cpu"}
        tables = core.build_tables(topo, **kw)
        sim = sim_cls(tables, cfg_cls(**CFG), failures=sched, **kw)
        tr = tr_cls("uniform", load=0.6)
        holder = [sim.make_state(tr, 4)]
        hook = ft.schedule_fault_hook(sim, holder, slots_per_step=2)

        def step_fn(state, batch, sim=sim, tr=tr, holder=holder):
            holder[0] = sim.run_chunk(holder[0], tr, 2)
            return holder[0], {}

        run = ft.FaultTolerantRunner(step_fn, lambda s: None,
                                     ck_cls(str(tmp_path / name)),
                                     ft.FTConfig(ckpt_every=100),
                                     fault_hook=hook)
        state, step, _ = run.run(holder[0], 0, 10)
        assert step == 10
        finals.append(state)
        if name == "jax":
            sim.close()
        with pytest.raises(ValueError, match="FailureSchedule"):
            ft.schedule_fault_hook(object(), [None])
    _assert_states_equal(finals[1], finals[0])
