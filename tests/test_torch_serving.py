"""The open-loop arrival source and the ``serving`` metric against the JAX
reference.

* The engine's ``Traffic("arrival")`` state for state against the live
  reference engine after 24 slots (run seed 3, so the key goes through
  ``fold_in``): ``poisson``, ``pareto`` and ``diurnal`` on
  ``mrls(14, 3, 3)`` (Polarized) and ``dragonfly(4, 2, 2)`` (ugal), in
  jax's partitionable threefry stream and, on the MRLS, the original
  one; a FIFO that overflows (``arr_depth`` 2 at load 0.95, and 1 under
  pareto batches) and a starved pool (48 packets).  Batched:
  ``make_batch_state`` key for key and ``run_chunk_batch`` against the
  reference's ``vmap``, in both streams.
* The two float32 maps the reference computes inside its XLA step, over
  their whole finite domains: the pareto batch size of each of the 2^23
  uniform draws, and the diurnal rate at slots 0 .. 2^16, bitwise
  against the jitted ``jnp`` expressions, for the parameters
  ``chip_smoke.py`` phase 16 runs and more; ``arrivals.sinf`` against
  ``jnp.sin``.
* The conservation ledger ``arrived == backlog + sum(msg_rem) +
  created`` on both packages' states.
* ``run_serving`` / ``run_serving_batch`` outputs (NaN percentiles
  where a replica delivered nothing); ``run(Experiment(metric=
  "serving", replicas=3))`` and ``run_all``'s seed folding against
  ``repro.api``'s records.
* ``serve_sweep`` of ``examples/specs/tiny_serving.json`` and ``python
  -m repro_torch.api serve-sweep --device cpu`` against the reference's
  records; the bridge's shapes, programs and specs for both archs;
  ``ServingSpec`` round trips and every validator's message.

Tolerance: zero.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro.serving as jax_serving
import repro_torch.api as port_api
import repro_torch.core as port_core
import repro_torch.serving as port_serving
from repro.api.cli import main as jax_cli_main
from repro.configs import get_config as jax_get_config
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro_torch.api.__main__ import main as cli_main
from repro_torch.configs import get_config
from repro_torch.convert import state_to_numpy
from repro_torch.simulator import arrivals
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_SERVING = ROOT / "examples" / "specs" / "tiny_serving.json"

FABRICS = {
    "mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0), "polarized"),
    "df": ("dragonfly", dict(a=4, p=2, h=2), "ugal"),
}
PROCESSES = {
    "poisson": dict(process="poisson", load=0.7),
    "pareto": dict(process="pareto", load=0.6, pareto_alpha=1.5,
                   pareto_cap=16),
    "diurnal": dict(process="diurnal", load=0.5, diurnal_amp=0.9,
                    diurnal_period=8),
}
# a FIFO that overflows: depth 2 under poisson at 0.95 with a pool of 48
# packets (the pool starves, the endpoints stay busy), depth 1 under
# pareto batches
OVERFLOW = {
    "overflow-starved": (dict(process="poisson", load=0.95, arr_depth=2),
                         48),
    "overflow-pareto": (dict(process="pareto", load=0.9, pareto_alpha=1.2,
                             pareto_cap=64, arr_depth=1), None),
}
SEED, SEEDS, SLOTS = 3, (3, 4, 5), 24
# (fabric, traffic knobs, pool, partitionable stream)
CASES = ([(f, PROCESSES[p], None, True) for f in FABRICS for p in PROCESSES]
         + [("mrls", PROCESSES[p], None, False)
            for p in ("pareto", "diurnal")]
         + [("mrls", kw, pool, True) for kw, pool in OVERFLOW.values()])


def _id(case):
    fabric, kw, pool, pt = case
    knobs = ",".join(f"{k}={v}" for k, v in kw.items() if k != "process")
    return (f"{fabric}-{kw['process']}[{knobs}]"
            + ("" if pool is None else f"-pool{pool}")
            + ("" if pt else "-original"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(fabric, pool=None):
    return dict(policy=FABRICS[fabric][2], max_hops=10, pool=pool or 4096)


@pytest.fixture(scope="module")
def tables():
    """``{fabric: (reference tables, port tables)}``."""
    return {name: (jax_core.build_tables(getattr(jax_core, fam)(**params)),
                   port_core.build_tables(getattr(port_core, fam)(**params),
                                          device="cpu"))
            for name, (fam, params, _) in FABRICS.items()}


def _jax_run(tables, case, seeds=None):
    """The reference's state after ``SLOTS`` slots, scalar (run seed
    ``SEED``) or batched over ``seeds``."""
    fabric, kw, pool, pt = case
    tr = JaxTraffic("arrival", **kw)
    with jax.threefry_partitionable(pt), \
            JaxSimulator(tables[fabric][0], JaxConfig(**_cfg(fabric, pool))) \
            as sim:
        if seeds is None:
            return jax.device_get(sim.run_chunk(
                sim.make_state(tr, seed=SEED), tr, SLOTS))
        return jax.device_get(sim.run_chunk_batch(
            sim.make_batch_state(tr, seeds), tr, SLOTS))


def _port_sim(tables, case):
    fabric, _, pool, pt = case
    return Simulator(tables[fabric][1],
                     SimConfig(**_cfg(fabric, pool),
                               threefry_partitionable=pt), device="cpu")


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=f"state[{k!r}]")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_arrival_state_after_24_slots_equals_reference(tables, case):
    want = _jax_run(tables, case)
    sim = _port_sim(tables, case)
    tr = Traffic("arrival", **case[1])
    st = sim.make_state(tr, seed=SEED)
    sim.run_chunk(st, tr, SLOTS)
    _assert_states_equal(state_to_numpy(st), want)
    if case[1] in [kw for kw, _ in OVERFLOW.values()]:
        # the case does what its name says
        assert int(want["arr_drop"]) > 0
        if case[2] is not None:
            assert int(want["pool_stall"]) > 0


BATCH_CASES = [("mrls", PROCESSES["pareto"], None, True),
               ("mrls", PROCESSES["diurnal"], None, False),
               ("df", PROCESSES["poisson"], None, True),
               ("mrls",) + OVERFLOW["overflow-starved"] + (True,)]


@pytest.mark.parametrize("case", BATCH_CASES, ids=_id)
def test_batched_arrival_state_equals_reference(tables, case):
    fabric, kw, pool, pt = case
    tr, jtr = Traffic("arrival", **kw), JaxTraffic("arrival", **kw)
    sim = _port_sim(tables, case)
    with JaxSimulator(tables[fabric][0],
                      JaxConfig(**_cfg(fabric, pool))) as jsim:
        fresh = jax.device_get(jsim.make_batch_state(jtr, SEEDS))
    _assert_states_equal(state_to_numpy(sim.make_batch_state(tr, SEEDS)),
                         fresh)
    st = sim.run_chunk_batch(sim.make_batch_state(tr, SEEDS), tr, SLOTS)
    _assert_states_equal(state_to_numpy(st), _jax_run(tables, case, SEEDS))


# ---------------------------------------------------------------------- #
# the float32 maps, over their whole domains
# ---------------------------------------------------------------------- #
# chip_smoke.py phase 16 runs (1.5, 32); the other three probe the cap
# and the shape (at (1.5, 16), (1.5, 64) and (1.2, 64) the base rounded
# twice, as eager jnp would compute it, changes batch sizes)
PARETO_PARAMS = ((1.5, 16), (1.5, 32), (1.5, 64), (1.2, 64))


@pytest.mark.parametrize("alpha,cap", PARETO_PARAMS)
def test_pareto_batch_map_is_the_references_over_every_draw(alpha, cap):
    u = torch.arange(arrivals.UNIFORM_STEPS, dtype=torch.int32).to(
        torch.float32) * 2.0 ** -23

    @jax.jit
    def batch(u):
        # the reference engine's expression, in a jitted program as its
        # step runs it
        x = (1.0 - u * (1.0 - float(cap) ** -alpha)) ** (-1.0 / alpha)
        return jnp.clip(jnp.floor(x), 1, cap).astype(jnp.int32)

    want = np.asarray(batch(jnp.asarray(u.numpy())))
    got = arrivals.pareto_batch(u, arrivals.pareto_thresholds(alpha, cap))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (load, amplitude, period): phase 16's, the spec default, and two whose
# amplitude makes 1 + amp * sin round differently without the fused
# multiply-add
DIURNAL_PARAMS = ((0.6, 0.5, 64), (0.5, 0.5, 512), (0.3, 0.9, 1000),
                  (0.4, 0.7, 333))


@pytest.mark.parametrize("load,amp,period", DIURNAL_PARAMS)
def test_diurnal_rate_is_the_references_at_every_slot(load, amp, period):
    slots = np.arange((1 << 16) + 1, dtype=np.int32)
    w = 2.0 * np.pi / period

    @jax.jit
    def rate(slot):
        return load * (1.0 + amp * jnp.sin(w * slot.astype(jnp.float32)))

    want = np.asarray(rate(jnp.asarray(slots)))
    got = arrivals.diurnal_rate(torch.from_numpy(slots), load, amp,
                                period).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sinf_is_the_references_sin():
    rng = np.random.default_rng(0)
    # every float32 exponent from 2^-126 to 2^127, and the slot arguments
    # of a long diurnal run
    bits = rng.integers(0x00800000, 0x7f800000, 1 << 20, dtype=np.uint32)
    y = np.concatenate([bits.view(np.float32), np.float32(2 * np.pi / 7)
                        * np.arange(1 << 20, dtype=np.float32), [0.0]])
    y = y.astype(np.float32)
    want = np.asarray(jax.jit(jnp.sin)(jnp.asarray(y)))
    got = arrivals.sinf(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_f32_rounds_once():
    a = np.float32(1 + 2 ** -12)
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24: a separate product loses 2^-24
    got = arrivals.fma_f32(torch.tensor([a]), float(a), -1.0)
    assert got.item() == 2 ** -11 + 2 ** -24
    assert (torch.tensor([a]) * a - 1.0).item() == 2 ** -11


# ---------------------------------------------------------------------- #
# the conservation ledger and the serving drivers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("process", list(PROCESSES) + ["overflow-starved"])
def test_conservation_ledger(tables, process):
    kw, pool = (OVERFLOW[process] if process in OVERFLOW
                else (PROCESSES[process], None))
    case = ("mrls", kw, pool, True)
    want = _jax_run(tables, case)
    sim = _port_sim(tables, case)
    tr = Traffic("arrival", **kw)
    st = sim.make_state(tr, seed=SEED)
    sim.run_chunk(st, tr, SLOTS)
    backlog = Simulator.arrival_backlog(st)
    assert backlog == JaxSimulator.arrival_backlog(want)
    assert int(st["arrived"]) == (backlog + int(st["msg_rem"].sum())
                                  + int(st["created"]))
    assert int(st["arrived"]) > 0


def _assert_outputs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "state":
            _assert_states_equal(state_to_numpy(got[k]),
                                 jax.device_get(want[k]))
            continue
        w = want[k]
        assert type(got[k]) is type(w), k
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("process", list(PROCESSES))
def test_run_serving_equals_reference(tables, process):
    kw = PROCESSES[process]
    with JaxSimulator(tables["mrls"][0], JaxConfig(**_cfg("mrls"))) as jsim:
        want = jsim.run_serving(JaxTraffic("arrival", **kw), warm=12,
                                measure=20, seed=SEED)
        want["state"] = jax.device_get(want["state"])
    sim = _port_sim(tables, ("mrls", kw, None, True))
    got = sim.run_serving(Traffic("arrival", **kw), warm=12, measure=20,
                          seed=SEED)
    _assert_outputs_equal(got, want)


def test_run_serving_batch_equals_reference(tables):
    # one slot at load 0.01: some replicas deliver nothing (NaN
    # percentiles), others a local packet in the slot it arrived
    kw = dict(process="poisson", load=0.01)
    seeds = tuple(range(8))
    with JaxSimulator(tables["mrls"][0], JaxConfig(**_cfg("mrls"))) as jsim:
        want = jsim.run_serving_batch(JaxTraffic("arrival", **kw), seeds,
                                      warm=0, measure=1)
        want["state"] = jax.device_get(want["state"])
    sim = _port_sim(tables, ("mrls", kw, None, True))
    got = sim.run_serving_batch(Traffic("arrival", **kw), seeds, warm=0,
                                measure=1)
    _assert_outputs_equal(got, want)
    assert np.isnan(got["p0.5"]).any()
    with pytest.raises(ValueError, match="needs Traffic"):
        sim.run_serving(Traffic("uniform"))
    with pytest.raises(ValueError, match="needs Traffic"):
        sim.run_serving_batch(Traffic("uniform"), seeds)


# ---------------------------------------------------------------------- #
# the serving metric through the runner
# ---------------------------------------------------------------------- #
TINY = {"network": {"family": "mrls",
                    "params": {"n_leaves": 14, "u": 3, "d": 3, "seed": 0}},
        "route": {"policy": "polarized", "max_hops": 10, "pool": 4096},
        "warm": 12, "measure": 24}
WORKLOADS = (
    {"pattern": "poisson", "load": 0.6},
    {"pattern": "pareto", "load": 0.5, "pareto_alpha": 1.5,
     "pareto_cap": 16},
    {"pattern": "diurnal", "load": 0.4, "diurnal_amp": 0.5,
     "diurnal_period": 16, "arr_depth": 4},
)


def _exp(api, workload, **kw):
    return api.Experiment.from_dict(dict(TINY, workload=workload, **kw))


@pytest.mark.parametrize("replicas", (1, 3))
@pytest.mark.parametrize("workload", WORKLOADS, ids=lambda w: w["pattern"])
def test_run_serving_metric_equals_reference(workload, replicas):
    got = port_api.run(_exp(port_api, workload, replicas=replicas),
                       device="cpu").to_dict()
    want = jax_api.run(_exp(jax_api, workload, replicas=replicas)).to_dict()
    assert got == want
    assert got["metric"] == "serving" and got["offered"] > 0


def test_run_all_folds_serving_seeds_as_reference():
    # seeds 0-2 of the pareto point fold into one batched run; the
    # poisson point runs alone
    exps = ([_exp(port_api, WORKLOADS[1], seed=s) for s in range(3)]
            + [_exp(port_api, WORKLOADS[0])])
    jexps = ([_exp(jax_api, WORKLOADS[1], seed=s) for s in range(3)]
             + [_exp(jax_api, WORKLOADS[0])])
    got = [r.to_dict() for r in port_api.run_all(exps, device="cpu")]
    want = [r.to_dict() for r in jax_api.run_all(jexps)]
    assert got == want
    # and each equals the scalar run of its seed
    assert got[1] == port_api.run(exps[1], device="cpu").to_dict()


def test_serve_sweep_and_cli_equal_reference(tmp_path, capsys):
    specs = [jax_serving.ServingSpec.from_dict(d) for d in
             json.loads(TINY_SERVING.read_text())["servings"]]
    want = jax_serving.serve_sweep_many(specs)
    got = port_serving.serve_sweep_many(
        [port_serving.ServingSpec.from_dict(s.to_dict()) for s in specs],
        device="cpu")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got[0]["request"]["completed"] and got[0]["saturation"]

    # the CLI on the file's pareto spec, with another seed
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps({"serving": dict(
        json.loads(TINY_SERVING.read_text())["servings"][1], measure=40)}))
    want_file, got_file = tmp_path / "want.json", tmp_path / "got.json"
    assert jax_cli_main(["serve-sweep", str(spec_file), "--seed", "2",
                         "--out", str(want_file)]) == 0
    want_out = capsys.readouterr().out
    assert cli_main(["serve-sweep", str(spec_file), "--seed", "2",
                     "--device", "cpu", "--out", str(got_file)]) == 0
    got_out = capsys.readouterr().out
    assert got_out == want_out.replace(str(want_file), str(got_file))
    assert json.loads(got_file.read_text()) == json.loads(
        want_file.read_text())


# ---------------------------------------------------------------------- #
# the bridge and the spec
# ---------------------------------------------------------------------- #
ARCHS = ("qwen3-1.7b", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_carry_the_references_fields(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "act", "qk_norm",
              "rope_theta", "norm_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if jcfg.moe is None:
        assert cfg.moe is None
    else:
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)


@pytest.mark.parametrize("phase", ("prefill", "decode", "moe"))
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_equals_reference(arch, phase):
    S = 42
    kw = dict(ranks=8, tokens=100, batch=3)
    if phase == "moe" and get_config(arch).moe is None:
        with pytest.raises(ValueError) as got:
            port_serving.request_phase_shape(get_config(arch), phase, **kw)
        with pytest.raises(ValueError) as want:
            jax_serving.request_phase_shape(jax_get_config(arch), phase,
                                            **kw)
        assert str(got.value) == str(want.value)
        return
    assert (port_serving.request_phase_shape(get_config(arch), phase, **kw)
            == jax_serving.request_phase_shape(jax_get_config(arch), phase,
                                               **kw))
    got = port_serving.request_to_program(arch, phase, S, ranks=8,
                                          tokens=100, batch=3)
    want = jax_serving.request_to_program(arch, phase, S, ranks=8,
                                          tokens=100, batch=3)
    assert got.name == want.name
    np.testing.assert_array_equal(np.asarray(got.partner),
                                  np.asarray(want.partner))
    np.testing.assert_array_equal(np.asarray(got.packets),
                                  np.asarray(want.packets))
    assert (port_serving.request_to_spec(arch, phase, S).to_dict()
            == jax_serving.request_to_spec(arch, phase, S).to_dict())


def test_bridge_registers_its_patterns_once():
    import importlib

    from repro_torch.serving import bridge
    from repro_torch.workloads import PROGRAM_BUILDERS
    before = {k: PROGRAM_BUILDERS[k] for k in ("lm_prefill", "lm_decode",
                                               "lm_moe")}
    importlib.reload(bridge)
    assert {k: PROGRAM_BUILDERS[k] for k in before} == before
    assert ("lm_moe", "collective", True) in port_api.workload_patterns()
    # a request leg runs through the runner as a collective
    res = port_api.run(port_api.Experiment.from_dict(dict(
        TINY, workload={"pattern": "lm_decode", "ranks": 8,
                        "vec_packets": 2})), device="cpu")
    assert res.metric == "completion" and res.completed


def test_serving_spec_round_trips():
    d = dict(json.loads(TINY_SERVING.read_text())["servings"][0])
    spec = port_serving.ServingSpec.from_dict(d)
    assert spec.to_dict() == jax_serving.ServingSpec.from_dict(d).to_dict()
    assert port_serving.ServingSpec.from_json(spec.to_json()) == spec
    assert spec.label() == "tiny.serve.poisson"
    unnamed = spec.replace(name="")
    assert unnamed.label() == jax_serving.ServingSpec.from_dict(
        dict(d, name="")).label()
    assert hash(spec) == hash(port_serving.ServingSpec.from_dict(d))


NET = {"family": "mrls", "params": {"n_leaves": 14, "u": 3, "d": 3}}
BAD_SPECS = (
    dict(loads=[]),
    dict(sat_ratio=0.0),
    dict(sat_ratio=1.5),
    dict(model="qwen3-1.7b", phase="train"),
    dict(process="gamma"),
    dict(loads=[0.0]),
    dict(loads=[1.2]),
    dict(arr_depth=0),
    dict(process="pareto", pareto_alpha=1.0),
    dict(process="pareto", pareto_cap=0),
    dict(process="pareto", loads=[3.0], pareto_cap=64, pareto_alpha=3.0),
    dict(process="diurnal", diurnal_period=1),
    dict(process="diurnal", diurnal_amp=1.5),
    dict(process="diurnal", loads=[0.8], diurnal_amp=0.5),
)


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: ",".join(
    f"{k}={v}" for k, v in d.items()))
def test_serving_spec_validators_equal_reference(bad):
    d = dict({"network": NET, "loads": [0.5]}, **bad)
    with pytest.raises(ValueError) as got:
        port_serving.ServingSpec.from_dict(d)
    with pytest.raises(ValueError) as want:
        jax_serving.ServingSpec.from_dict(d)
    assert str(got.value) == str(want.value)


def test_traffic_refuses_what_the_reference_refuses(tables):
    sim = _port_sim(tables, ("mrls", {}, None, True))
    with JaxSimulator(tables["mrls"][0], JaxConfig(**_cfg("mrls"))) as jsim:
        for kw in (dict(load=1.5), dict(process="pareto", pareto_alpha=0.5),
                   dict(process="diurnal", load=0.9, diurnal_amp=0.5)):
            with pytest.raises(ValueError) as got:
                sim.make_state(Traffic("arrival", **kw))
            with pytest.raises(ValueError) as want:
                jsim.make_state(JaxTraffic("arrival", **kw))
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        Traffic("arrival", process="uniform")
    with pytest.raises(ValueError) as want:
        JaxTraffic("arrival", process="uniform")
    assert str(got.value) == str(want.value)
