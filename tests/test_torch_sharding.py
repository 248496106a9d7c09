"""Replica placement across a device list, held to the reference's
``repro.parallel.sharding`` and its sharded engine paths.

The port's mesh may repeat a device, so the split and the merge run here
on the CPU (``["cpu"]``, ``["cpu", "cpu"]``) as they would over distinct
cards.  Checked against the live reference:

* ``ShardingRules`` / ``Sharder._resolve`` / ``pspec`` for every logical
  name under the model profile (3 and 2 axes, with and without sequence
  parallelism) and the simulator profile (both axes), with
  ``tests/test_sharded_engine.py``'s profile cases;
* ``sharding(names, shape)``'s divisibility fallback and
  ``param_shardings`` of the reduced Hymba and falcon-mamba specs on
  meshes of 2 x 2 and 1 x 2 x 2 devices (the reference in a child
  process with 4 forced host devices) and on the 1-device test mesh;
* ``run_chunk_sharded`` on the golden fabric (``mrls(14, 3, 3)``, the
  reference's blocked masks, polarized) at R = 2 and 4 over one and two
  shards: bitwise ``run_chunk_batch`` and state for state the
  reference's ``run_chunk_sharded`` on its 1-device mesh, in both
  threefry modes; its three refusals with the reference's messages; a
  slot launches each crossbar kernel once per shard;
* ``run_throughput_batch(sharder=)`` against the reference's;
* ``state_shardings`` entry for entry, ``shard_state`` + ``run_chunk``
  bitwise, and its refusal over distinct devices (built from
  ``torch.device("cpu")`` and ``torch.device("cuda", 0)``, touching no
  card);
* ``elastic_reshard``, ``Checkpointer.restore(shardings=)`` and
  ``FaultTolerantRunner(shardings=)``.

Tolerance: zero.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh as jax_test_mesh
from repro.models.common import param_shardings as jax_param_shardings
from repro.models.model import build_specs as jax_build_specs
from repro.parallel.sharding import Sharder as JaxSharder
from repro.parallel.sharding import ShardingRules as JaxRules
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro.simulator.engine import Traffic as JaxTraffic
from repro.workloads import compile_program as jax_compile
from repro.workloads import rabenseifner_program as jax_raben
from repro_torch.checkpointing import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import state_to_numpy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.common import (flatten_specs, init_params,
                                       param_shardings)
from repro_torch.models.model import build_specs
from repro_torch.parallel import sharding as port_sharding
from repro_torch.parallel.sharding import (Mesh, Placement, Sharder,
                                           ShardingRules, make_sim_mesh)
from repro_torch.runtime import fault_tolerance as port_ft
from repro_torch.simulator import engine as port_engine
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic
from repro_torch.workloads import compile_program, rabenseifner_program

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GOLDEN_FABRIC = dict(n_leaves=14, u=3, d=3, seed=0)
CFG = dict(policy="polarized", max_hops=10, pool=4096)
SLOTS = 24
NAMES = (None, "fsdp", "dp", "tp", "sp", "replica", "switch")
ARCHS = ("hymba-1.5b", "falcon-mamba-7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    """(reference tables with blocked masks, port tables)."""
    return (jax_core.build_tables(jax_core.mrls(**GOLDEN_FABRIC),
                                  masks="blocked"),
            port_core.build_tables(port_core.mrls(**GOLDEN_FABRIC),
                                   device="cpu"))


@pytest.fixture(scope="module")
def sim(tables):
    return Simulator(tables[1], SimConfig(**CFG), device="cpu")


def _mesh(n: int, axes=("replica",), sizes=None) -> Mesh:
    return Mesh((CPU,) * n, axes, sizes)


def _specs(placements) -> dict:
    """``{path: resolved axes}`` of a tree of placements or shardings."""
    out = {}
    for path, p in flatten_specs(placements):
        spec = p.spec
        out[path] = tuple(tuple(a) if isinstance(a, list) else a
                          for a in spec)
    return out


# ---------------------------------------------------------------------- #
# rules and resolution
# ---------------------------------------------------------------------- #
PROFILES = {
    "pod-data-model": (("pod", "data", "model"), False, False),
    "pod-data-model-sp": (("pod", "data", "model"), True, False),
    "data-model": (("data", "model"), False, False),
    "sim-replica": (("replica",), False, True),
    "sim-switch": (("switch",), False, True),
}


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_every_name_resolves_as_the_reference(profile):
    axes, sp, sim_profile = PROFILES[profile]
    jmesh = jax.make_mesh((1,) * len(axes), axes)
    mesh = _mesh(1, axes, (1,) * len(axes))
    if sim_profile:
        jrules, rules = JaxRules.for_sim_mesh(jmesh), \
            ShardingRules.for_sim_mesh(mesh)
    else:
        jrules = JaxRules.for_mesh(jmesh, sequence_parallel=sp)
        rules = ShardingRules.for_mesh(mesh, sequence_parallel=sp)
    assert rules == ShardingRules(**vars(jrules))
    jsh, sh = JaxSharder(jmesh, jrules), Sharder(mesh, rules)
    for name in NAMES:
        assert sh._resolve(name) == jsh._resolve(name), name
        assert sh.pspec((name, None)) == tuple(jsh.pspec((name, None)))
    assert sh.pspec(NAMES) == tuple(jsh.pspec(NAMES))
    with pytest.raises(ValueError) as want:
        jsh.pspec(("heads",))
    with pytest.raises(ValueError) as got:
        sh.pspec(("heads",))
    assert str(got.value) == str(want.value)
    if not sim_profile:     # the model profile is the default rule
        assert Sharder(mesh).rules == ShardingRules.for_mesh(mesh)


def test_sim_sharder_profile_resolves_replica_axis():
    """``tests/test_sharded_engine.py``'s profile cases, on the port."""
    sh = Sharder.for_simulator(device="cpu")
    assert sh.rules.replica == "replica" and sh.rules.switch is None
    assert sh.pspec(("replica", None))[0] == "replica"
    sw = Sharder.for_simulator(axis="switch", device="cpu")
    assert sw.rules.switch == "switch" and sw.rules.replica is None
    # the model-side logical names resolve to replicated, not an error
    assert sh.pspec(("fsdp", "tp")) == sh.pspec((None, None))


def test_make_sim_mesh_and_the_test_mesh(monkeypatch):
    mesh = make_sim_mesh(2, device="cpu")
    assert mesh.devices == (CPU, CPU) and mesh.shape == {"replica": 2}
    assert make_sim_mesh(axis="switch", device="cpu").shape == {"switch": 1}
    # more devices than there are: the reference's message
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="^asked for 2 devices, have 1$"):
        make_sim_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sim_mesh()
    got, want = make_test_mesh(device="cpu"), jax_test_mesh()
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape) and got.devices == (CPU,)
    with pytest.raises(ValueError, match="need 4 devices"):
        Mesh((CPU,) * 3, ("data", "model"), (2, 2))


# the reference on meshes of several devices, in a child process with 4
# forced host devices (which must not leak into this one: conftest)
_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config, reduced
from repro.models.common import param_shardings
from repro.models.model import build_specs
from repro.parallel.sharding import Sharder
cases = json.loads(sys.argv[1])
def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]
out = {"sharding": [], "params": {}}
for shape, axes, names, dims in cases["sharding"]:
    mesh = jax.make_mesh(tuple(shape), tuple(axes))
    sh = (Sharder.for_simulator(mesh) if axes == ["replica"]
          else Sharder(mesh))
    out["sharding"].append(spec(sh.sharding(names, dims)))
for arch in cases["archs"]:
    sh = Sharder(jax.make_mesh((1, 2, 2), ("pod", "data", "model")))
    tree = param_shardings(build_specs(reduced(get_config(arch))), sh)
    out["params"][arch] = {
        "/".join(k.key for k in kp): spec(v)
        for kp, v in jax.tree.flatten_with_path(tree)[0]}
print(json.dumps(out))
"""
SHARDING_CASES = [
    ((2, 2), ("data", "model"), ("fsdp", "tp"), (4, 6)),
    ((2, 2), ("data", "model"), ("fsdp", "tp"), (3, 6)),
    ((2, 2), ("data", "model"), ("fsdp", "tp"), (4, 5)),
    ((2, 2), ("data", "model"), ("fsdp", None, "tp"), (3, 2, 5)),
    ((2, 2), ("data", "model"), ("tp", "dp", "sp"), (8, 2, 7)),
    ((1, 2, 2), ("pod", "data", "model"), ("fsdp", "tp"), (4, 6)),
    ((1, 2, 2), ("pod", "data", "model"), ("fsdp", "tp"), (3, 3)),
    ((4,), ("replica",), ("replica", None), (8, 3)),
    ((4,), ("replica",), ("replica", None), (6, 3)),
]


@pytest.fixture(scope="module")
def reference_multi():
    cases = {"sharding": [list(map(list, c)) for c in SHARDING_CASES],
             "archs": list(ARCHS)}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cases)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _as_lists(spec) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def test_sharding_drops_axes_that_do_not_divide(reference_multi):
    for (shape, axes, names, dims), want in zip(
            SHARDING_CASES, reference_multi["sharding"]):
        rules = (ShardingRules.for_sim_mesh if axes == ("replica",)
                 else ShardingRules.for_mesh)
        mesh = _mesh(int(np.prod(shape)), axes, shape)
        got = Sharder(mesh, rules(mesh)).sharding(names, dims)
        assert isinstance(got, Placement) and got.mesh is mesh
        assert _as_lists(got.spec) == want, (shape, names, dims)
        # every device of the mesh is the CPU: the whole tensor goes there
        assert got.devices() == (CPU,)
    # without a shape nothing is dropped
    sh = Sharder(_mesh(4, ("data", "model"), (2, 2)))
    assert sh.sharding(("fsdp", "tp")).spec == ("data", "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_the_reference(arch, reference_multi):
    cfg = reduced(get_config(arch))
    specs = build_specs(cfg)
    # the 1 x 2 x 2 mesh, in the child process
    mesh = _mesh(4, ("pod", "data", "model"), (1, 2, 2))
    got = {p: _as_lists(s) for p, s in
           _specs(param_shardings(specs, Sharder(mesh))).items()}
    assert got == reference_multi["params"][arch]
    # and the 1-device test mesh, in process
    jshard = jax_param_shardings(jax_build_specs(jax_reduced(
        jax_get_config(arch))), JaxSharder(jax_test_mesh()))
    want = {"/".join(k.key for k in kp): tuple(v.spec)
            for kp, v in jax.tree.flatten_with_path(jshard)[0]}
    got = _specs(param_shardings(specs,
                                 Sharder(make_test_mesh(device="cpu"))))
    assert got == want


# ---------------------------------------------------------------------- #
# the replica axis
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_chunks(tables):
    """The reference's ``run_chunk_sharded`` on its 1-device mesh, by
    (R, threefry mode)."""
    out = {}
    tr = JaxTraffic("uniform", load=0.7)
    for pt in (True, False):
        with jax.threefry_partitionable(pt), JaxSimulator(
                tables[0], JaxConfig(**CFG)) as jsim:
            for r in (2, 4):
                st = jsim.make_batch_state(tr, list(range(r)))
                out[r, pt] = jax.device_get(jsim.run_chunk_sharded(
                    st, tr, SLOTS, JaxSharder.for_simulator()))
    return out


@pytest.mark.parametrize("pt", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("reps", [2, 4])
def test_run_chunk_sharded_equals_batch_and_reference(tables,
                                                      reference_chunks,
                                                      reps, shards, pt):
    sim = Simulator(tables[1], SimConfig(**CFG, threefry_partitionable=pt),
                    device="cpu")
    tr = Traffic("uniform", load=0.7)
    batch = sim.run_chunk_batch(sim.make_batch_state(tr, range(reps)), tr,
                                SLOTS)
    st = sim.make_batch_state(tr, range(reps))
    got = sim.run_chunk_sharded(st, tr, SLOTS,
                                Sharder.for_simulator(_mesh(shards)))
    assert got is st
    assert set(got) == set(batch)
    for k in batch:
        assert got[k].dtype == batch[k].dtype, k
        assert torch.equal(got[k], batch[k]), k
    want = reference_chunks[reps, pt]
    got = state_to_numpy(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert (got["ejected"] > 0).all()


def test_a_program_state_shards_its_replicas_and_shares_the_program(sim):
    """A barrier program's shared arrays ride every shard unbatched; the
    result is the unsharded batch's."""
    cp = compile_program(rabenseifner_program(sim.S, 16, 4))
    tr = sim.program_traffic(cp)
    batch = sim.run_chunk_batch(sim.make_program_batch_state(cp, [0, 1]),
                                tr, 12)
    st = sim.make_program_batch_state(cp, [0, 1])
    specs = sim.batch_pspecs(st, "replica")
    for k in port_engine.PROG_SHARED:
        assert specs[k] == (None,) * port_engine.PROG_SHARED[k]
    assert specs["qlen"] == ("replica", None)
    got = sim.run_chunk_sharded(st, tr, 12, Sharder.for_simulator(_mesh(2)))
    for k in batch:
        assert torch.equal(got[k], batch[k]), k


def test_refusals_carry_the_references_messages(tables, sim):
    tr, jtr = Traffic("uniform", load=0.7), JaxTraffic("uniform", load=0.7)
    with JaxSimulator(tables[0], JaxConfig(**CFG)) as jsim:
        jst = jsim.make_batch_state(jtr, [0, 1])
        with pytest.raises(ValueError) as no_axis:
            jsim.run_chunk_sharded(jst, jtr, 1,
                                   JaxSharder.for_simulator(axis="switch"))
        with pytest.raises(ValueError) as scalar:
            jsim.run_chunk_sharded(jsim.make_state(jtr, 0), jtr, 1,
                                   JaxSharder.for_simulator())
        with pytest.raises(ValueError) as no_switch:
            jsim.state_shardings(jsim.make_state(jtr, 0),
                                 JaxSharder.for_simulator())
    st = sim.make_batch_state(tr, [0, 1])
    with pytest.raises(ValueError) as got:
        sim.run_chunk_sharded(st, tr, 1, Sharder.for_simulator(
            axis="switch", device="cpu"))
    assert str(got.value) == str(no_axis.value)
    with pytest.raises(ValueError) as got:
        sim.run_chunk_sharded(sim.make_state(tr, 0), tr, 1,
                              Sharder.for_simulator(device="cpu"))
    assert str(got.value) == str(scalar.value)
    # the reference's third message (it needs a mesh of 2 devices there)
    with pytest.raises(ValueError) as got:
        sim.run_chunk_sharded(sim.make_batch_state(tr, [0, 1, 2]), tr, 1,
                              Sharder.for_simulator(_mesh(2)))
    assert str(got.value) == ("3 replicas do not divide over 2 devices on "
                              "mesh axis 'replica'")
    with pytest.raises(ValueError) as got:
        sim.state_shardings(sim.make_state(tr, 0),
                            Sharder.for_simulator(device="cpu"))
    assert str(got.value) == str(no_switch.value)


def test_each_shard_launches_each_kernel(sim, monkeypatch):
    """A slot over n shards calls ``vc_prearb`` speedup + 1 and
    ``switch_arbitrate_rows`` speedup times a shard."""
    calls = {"vc_prearb": 0, "switch_arbitrate_rows": 0}

    def counted(name):
        fn = getattr(port_engine, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call
    for name in calls:
        monkeypatch.setattr(port_engine, name, counted(name))
    tr = Traffic("uniform", load=0.7)
    speedup = sim.cfg.speedup
    for shards in (1, 2, 4):
        for k in calls:
            calls[k] = 0
        sim.run_chunk_sharded(sim.make_batch_state(tr, range(4)), tr, 3,
                              Sharder.for_simulator(_mesh(shards)))
        assert calls == {"vc_prearb": 3 * shards * (speedup + 1),
                         "switch_arbitrate_rows": 3 * shards * speedup}


def test_run_throughput_batch_with_a_sharder_equals_reference(tables, sim):
    with JaxSimulator(tables[0], JaxConfig(**CFG)) as jsim:
        want = jsim.run_throughput_batch(JaxTraffic("uniform", load=0.8),
                                         [0, 1], warm=8, measure=12,
                                         sharder=JaxSharder.for_simulator())
        want_st = jax.device_get(want["state"])
    got = sim.run_throughput_batch(Traffic("uniform", load=0.8), [0, 1],
                                   warm=8, measure=12,
                                   sharder=Sharder.for_simulator(_mesh(2)))
    plain = sim.run_throughput_batch(Traffic("uniform", load=0.8), [0, 1],
                                     warm=8, measure=12)
    for k in ("throughput", "avg_hops", "ejected", "pool_stall"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    got_st = state_to_numpy(got["state"])
    for k in want_st:
        np.testing.assert_array_equal(got_st[k], np.asarray(want_st[k]),
                                      err_msg=k)


def test_close_drops_the_device_views(sim):
    """A view on another device holds copies of the tables, made once;
    the simulator's own device needs none.  ``meta`` tensors stand in
    for a second card."""
    assert sim._device_view("cpu") is sim
    view = sim._device_view("meta")
    assert view is sim._device_view(torch.device("meta"))
    assert view.device == torch.device("meta") and view.S == sim.S
    assert view.dist.device.type == "meta" and sim.dist.device == CPU
    assert view.min_mask.shape == sim.min_mask.shape
    assert view._rep_offsets == {} and view.tables is sim.tables
    sim.close()
    assert sim._views == {}
    assert sim._device_view("meta") is not view
    sim.close()


# ---------------------------------------------------------------------- #
# the switch axis
# ---------------------------------------------------------------------- #
def _jax_program_state(jsim, S):
    cp = jax_compile(jax_raben(S, 16, 4))
    return jsim.make_program_state(cp, 0)


def test_state_shardings_layout_equals_the_reference(tables, sim):
    jsh = JaxSharder.for_simulator(axis="switch")
    sh = Sharder.for_simulator(axis="switch", device="cpu")
    jtr = JaxTraffic("uniform", load=0.7)
    with JaxSimulator(tables[0], JaxConfig(**CFG)) as jsim:
        want = [jsim.state_shardings(jsim.make_state(jtr, 0), jsh),
                jsim.state_shardings(_jax_program_state(jsim, sim.S), jsh)]
    cp = compile_program(rabenseifner_program(sim.S, 16, 4))
    got = [sim.state_shardings(sim.make_state(Traffic("uniform", load=0.7),
                                              0), sh),
           sim.state_shardings(sim.make_program_state(cp, 0), sh)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].spec == tuple(w[k].spec), k
    # queue-major and NIC-major entries split, pool-indexed ones do not
    assert got[0]["qbuf"].spec == ("switch", None)
    assert got[0]["eq_len"].spec == ("switch",)
    assert got[0]["p_sd"].spec == (None,) and got[0]["slot"].spec == ()


def test_shard_state_then_run_chunk_is_bitwise(sim):
    tr = Traffic("uniform", load=0.7)
    want = sim.run_chunk(sim.make_state(tr, 3), tr, SLOTS)
    for n in (1, 2):
        sh = Sharder.for_simulator(_mesh(n, ("switch",)))
        st = sim.shard_state(sim.make_state(tr, 3), sh)
        assert all(v.device == CPU for v in st.values())
        got = sim.run_chunk(st, tr, SLOTS)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_shard_state_refuses_distinct_devices_before_placing(sim):
    tr = Traffic("uniform", load=0.7)
    st = sim.make_state(tr, 0)
    before = {k: v.clone() for k, v in st.items()}
    distinct = Sharder.for_simulator(
        Mesh((CPU, torch.device("cuda", 0)), ("switch",)))
    with pytest.raises(NotImplementedError, match="item 16") as err:
        sim.shard_state(st, distinct)
    assert "_link_phase" in str(err.value)
    assert all(v.device == CPU and torch.equal(v, before[k])
               for k, v in st.items())
    with pytest.raises(ValueError, match="for a simulator on cpu"):
        sim.shard_state(st, Sharder.for_simulator(
            Mesh((torch.device("cuda", 0),), ("switch",))))


# ---------------------------------------------------------------------- #
# model placement
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def hymba():
    cfg = reduced(get_config("hymba-1.5b"))
    specs = build_specs(cfg)
    return specs, init_params(specs, 0, "cpu")


def _leaves_equal(a, b):
    la, lb = flatten_specs(a), flatten_specs(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_elastic_reshard_moves_every_leaf_whole(hymba):
    specs, params = hymba
    for sh in (Sharder(make_test_mesh(device="cpu")),
               Sharder(_mesh(4, ("pod", "data", "model"), (1, 2, 2)))):
        moved = port_ft.elastic_reshard(params, sh, specs)
        _leaves_equal(moved, params)
        assert all(t.device == CPU for _, t in flatten_specs(moved))
    # a leaf split over distinct devices is refused, and a replicated one
    # is not split
    mesh = Mesh((CPU, torch.device("cuda", 0)), ("data", "model"), (1, 2))
    with pytest.raises(NotImplementedError, match="item 16"):
        port_ft.elastic_reshard(params, Sharder(mesh), specs)
    norm = param_shardings(specs, Sharder(mesh))["final_norm"]
    assert norm.devices() == (CPU,)


def test_restore_with_shardings_replaces_the_tree(hymba, tmp_path):
    specs, params = hymba
    ck = Checkpointer(str(tmp_path))
    ck.save(3, params)
    shd = param_shardings(specs, Sharder(make_test_mesh(device="cpu")))
    tree, meta = ck.restore(params, shardings=shd)
    assert meta["step"] == 3
    _leaves_equal(tree, params)
    # the runner restores through the same path after a failure
    fails = iter([False, True, False, False])

    def step(state, batch):
        if next(fails):
            raise RuntimeError("injected")
        return {k: v for k, v in state.items()}, {"loss": 0.0}
    run = port_ft.FaultTolerantRunner(
        step, lambda s: None, ck, port_ft.FTConfig(ckpt_every=1),
        sleep_fn=lambda d: None, shardings=shd)
    state, at, _ = run.run(params, 0, 3)
    assert at == 3 and run.total_failures == 1
    _leaves_equal(state, params)


def test_sharding_module_names_the_refusal_item():
    assert "item 16" in port_sharding.SPLIT_REFUSAL
    with pytest.raises(NotImplementedError, match="item 16"):
        Placement(Mesh((CPU, torch.device("cuda", 0)), ("model",)),
                  ("model",)).place(torch.zeros(2))
