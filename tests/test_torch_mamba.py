"""The port's falcon-mamba (the ``mamba`` block kind) against the
reference's, at the reduced config, and the layer-slab weight synthesis.

``reduced(falcon-mamba-7b)`` (4 attention-free Mamba-1 layers, width 128,
``d_inner`` 256, state 16, vocab 512) with its parameters from the
reference's ``init_params``, moved through ``params_from_jax``.  Checked:
the config field for field (full and reduced), the specs leaf for leaf
(shape, dtype, init, scale and sharding axes), the prefill logits and the
``{"conv", "ssm"}`` cache, 8 teacher-forced decode steps, ``generate``'s
tokens, the CLI, and the numpy synthesis drawn a block of rows at a time
(``leaf_blocks_np``, ``init_params(threads=)``) against the whole-leaf
draw.

Tolerances, with reasons (those of ``tests/test_torch_hymba.py``): each
bf16 projection is one float32-accumulated product rounded once, as the
reference computes it on a CPU, but sums run in another order (the port
scans the prompt in one pass where the reference scans chunks of 16 with
``lax.associative_scan``), so single values may flip by one bf16 ulp.
Logits, of magnitude below 1, agree to 2^-6 (two ulps at the largest
logit) and the caches to 2^-7 of their largest value: one bf16 ulp, also
for the float32 SSM state, whose terms are products of bf16 inputs that
may sit one ulp apart.  Greedy tokens may differ only where the
reference's top-1/top-2 margin is within twice the logit tolerance, and
are compared up to the first such difference.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import ServeSession as JaxServeSession
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec
from repro.models.model import build_specs as jax_build_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import prefill as jax_prefill
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_to_numpy, params_from_jax
from repro_torch.launch.serve import ServeSession
from repro_torch.models import common
from repro_torch.models.common import (ParamSpec, flatten_specs, init_params,
                                       init_params_np, leaf_blocks_np,
                                       params_to_torch, spec_leaf_np)
from repro_torch.models.model import build_specs, decode_step, plan, prefill

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "falcon-mamba-7b"
LOGIT_TOL = 2 ** -6
CACHE_TOL = 2 ** -7
DECODE_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, port cfg, jax params, port params, sharder, mesh)."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jax_init_params(jax_build_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    mesh = make_test_mesh()
    return jcfg, cfg, jparams, params, Sharder(mesh), mesh


@pytest.fixture(scope="module")
def jax_steps(models):
    jcfg, _, _, _, sh, _ = models
    return (jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, jcfg, sh)),
            jax.jit(lambda p, c, t, pos: jax_decode_step(p, c, t, pos, jcfg,
                                                         sh)))


def _prompt(S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (2, S),
                                                dtype=np.int32)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(tree))


def _check_logits(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def _check_cache(got: dict, want: dict):
    got, want = cache_to_numpy(got), _f32(want)
    assert got.keys() == want.keys() == {"m"}
    assert got["m"].keys() == want["m"].keys() == {"conv", "ssm"}
    for k, w in want["m"].items():
        assert got["m"][k].shape == w.shape, k
        np.testing.assert_allclose(got["m"][k], w, rtol=0,
                                   atol=CACHE_TOL * np.abs(w).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------- #
# config and specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_config_field_for_field(cut):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if cut:
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    for f in dataclasses.fields(cfg):
        if f.name == "moe":
            assert cfg.moe is None and jcfg.moe is None
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert [dataclasses.astuple(g) for g in plan(cfg)] == \
        [("mamba", cfg.n_layers, "m")]


def test_reduced_takes_the_general_case():
    """The ssm family takes the reference's general ``reduced``; the
    hybrid override and the MoE experts stay as the reference has them."""
    for arch in (ARCH, "hymba-1.5b", "qwen3-1.7b", "qwen3-moe-235b-a22b",
                 "nemotron-4-15b", "starcoder2-15b", "command-r-plus-104b"):
        cfg, jcfg = reduced(get_config(arch)), jax_reduced(
            jax_get_config(arch))
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "tp_heads", "sliding_window",
                  "full_attn_layers", "dense_layers", "dense_d_ff"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        if jcfg.moe is not None:
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)


@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_specs_equal_the_reference(cut):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if cut:
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    ref = jax.tree.flatten_with_path(jax_build_specs(jcfg),
                                     is_leaf=is_spec)[0]
    port = flatten_specs(build_specs(cfg))
    assert ["/".join(k.key for k in kp) for kp, _ in ref] == \
        [p for p, _ in port]
    for (_, r), (_, s) in zip(ref, port):
        assert (tuple(r.shape), r.dtype, r.init, r.scale, tuple(r.axes)) == \
            (tuple(s.shape), s.dtype, s.init, s.scale, s.axes)
    assert cfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------- #
# the model against the reference
# ---------------------------------------------------------------------- #
def test_params_from_jax_keeps_every_bit(models):
    _, cfg, jparams, params, _, _ = models
    assert set(params["groups"]) == {"m"}
    want = jax.tree.leaves(jax.device_get(jparams))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    bad = jax.device_get(jparams)
    bad["groups"]["m"]["ssm"]["A_log"] = bad["groups"]["m"]["ssm"]["A_log"][1:]
    with pytest.raises(ValueError, match="groups/m/ssm/A_log"):
        params_from_jax(bad, cfg, "cpu")


def test_numpy_weights_feed_both_packages(models, jax_steps):
    """The golden's path at small size: the seeded numpy weights, rounded
    to bf16 by each framework, are the same bits on both sides, and the
    two models agree on them."""
    _, cfg, _, _, _, mesh = models
    specs = build_specs(cfg)
    arrays = init_params_np(specs, 7)
    params = params_to_torch(specs, arrays, "cpu")
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                           arrays, specs,
                           is_leaf=lambda x: isinstance(x, np.ndarray))
    moved = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    for a, c in zip(jax.tree.leaves(params), jax.tree.leaves(moved)):
        assert torch.equal(a, c)
    toks = _prompt(24, cfg.vocab, seed=7)
    with jax.set_mesh(mesh):
        want, _ = jax_steps[0](jparams, jnp.asarray(toks))
    got, _ = prefill(params, torch.from_numpy(toks), cfg)
    _check_logits(got, want)


@pytest.mark.parametrize("S", [20, 40, 64])
def test_prefill_logits_and_caches(models, jax_steps, S):
    _, cfg, jparams, params, _, mesh = models
    toks = _prompt(S, cfg.vocab)
    with jax.set_mesh(mesh):
        want_logits, want_cache = jax_steps[0](jparams, jnp.asarray(toks))
    logits, cache = prefill(params, torch.from_numpy(toks), cfg)
    assert logits.shape == (2, 1, cfg.vocab_padded)
    di = cfg.ssm_expand * cfg.d_model
    assert cache["m"]["conv"].shape == (cfg.n_layers, 2, di, cfg.ssm_conv - 1)
    assert cache["m"]["ssm"].shape == (cfg.n_layers, 2, di, cfg.ssm_state)
    assert cache["m"]["ssm"].dtype == torch.float32
    _check_logits(logits, want_logits)
    _check_cache(cache, want_cache)


@pytest.mark.parametrize("S", [20, 40])
def test_teacher_forced_decode(models, jax_steps, S):
    """8 decode steps on the same tokens; logits at every step and the
    whole cache, updated in place, at the end."""
    _, cfg, jparams, params, _, mesh = models
    toks = _prompt(S, cfg.vocab)
    feed = np.random.default_rng(S).integers(0, cfg.vocab,
                                             (DECODE_STEPS, 2, 1),
                                             dtype=np.int32)
    with jax.set_mesh(mesh):
        _, want_cache = jax_steps[0](jparams, jnp.asarray(toks))
    _, cache = prefill(params, torch.from_numpy(toks), cfg)
    ssm = cache["m"]["ssm"]
    for i in range(DECODE_STEPS):
        with jax.set_mesh(mesh):
            want_logits, want_cache = jax_steps[1](
                jparams, want_cache, jnp.asarray(feed[i]), jnp.int32(S + i))
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    S + i, cfg)
        _check_logits(logits, want_logits)
    assert cache["m"]["ssm"] is ssm
    _check_cache(cache, want_cache)


def test_generate_matches_the_reference(models, jax_steps):
    """Greedy tokens of both ServeSessions, up to the first difference,
    which may only come at a near tie of the reference."""
    jcfg, cfg, jparams, params, sh, mesh = models
    toks = _prompt(40, cfg.vocab, seed=5)
    max_new = 6
    with jax.set_mesh(mesh):
        want = JaxServeSession(jcfg, sh, params=jparams).generate(toks,
                                                                  max_new)
        logits, cache = jax_steps[0](jparams, jnp.asarray(toks))
        margins = []
        for i in range(max_new):
            top2 = np.sort(np.asarray(logits[:, -1, :jcfg.vocab],
                                      np.float32), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            if i + 1 < max_new:
                logits, cache = jax_steps[1](
                    jparams, cache, jnp.asarray(want[:, i:i + 1]),
                    jnp.int32(40 + i))
    got = ServeSession(cfg, params=params, device="cpu").generate(toks,
                                                                  max_new)
    assert got.shape == want.shape == (2, max_new) and got.dtype == np.int32
    for row in range(2):
        for i in range(max_new):
            if got[row, i] != want[row, i]:
                assert margins[i][row] <= 2 * LOGIT_TOL, (row, i)
                break


def test_cli_serves_the_reduced_falcon_mamba_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "24", "--max-new", "4"], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arch"] == "falcon-mamba-7b-smoke"
    assert out["generated"] == [2, 4]
    cfg = reduced(get_config(ARCH))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24),
                                                dtype=np.int32)
    want = ServeSession(cfg, device="cpu").generate(prompts, 4)
    assert out["sample"] == want[0].tolist()


# ---------------------------------------------------------------------- #
# the numpy synthesis a layer slab at a time
# ---------------------------------------------------------------------- #
LEAVES = [ParamSpec((5, 3, 7), scale=0.5),
          ParamSpec((6, 11), "float32", "dt_bias"),
          ParamSpec((4, 9, 16), "float32", "mamba_a"),
          ParamSpec((3, 5), init="zeros"), ParamSpec((7,), "float32", "ones")]


@pytest.mark.parametrize("block", [1, 21, 1 << 26])
@pytest.mark.parametrize("leaf", range(len(LEAVES)))
def test_layer_slabs_equal_the_whole_leaf(monkeypatch, leaf, block):
    """Blocks cut in C order, parts of a row where a row is longer than a
    block (``block`` 1 and 21 here; one layer of the full Qwen3 MoE's
    ``wi`` is 1.6 B values), drawn in turn from the leaf's one generator:
    together the whole leaf bit for bit, and with ``rows`` its first
    rows, which are also ``spec_leaf_np``'s prefix."""
    spec = LEAVES[leaf]
    whole = spec_leaf_np(spec, 3, leaf)
    monkeypatch.setattr(common, "_BLOCK_ELEMS", block)
    for rows in (None, 1, 2):
        want = whole if rows is None else whole[:rows]
        parts = list(leaf_blocks_np(spec, 3, leaf, rows=rows))
        assert [lo for lo, _, _ in parts] == list(range(0, want.size, block))
        assert all(len(b) == hi - lo <= block for lo, hi, b in parts)
        np.testing.assert_array_equal(
            np.concatenate([b for _, _, b in parts]), want.reshape(-1))
        if rows is not None:
            np.testing.assert_array_equal(
                spec_leaf_np(spec, 3, leaf, rows=rows), want)


@pytest.mark.parametrize("threads", [1, 3])
def test_init_params_in_slabs_equals_the_whole_draw(monkeypatch, threads):
    """``init_params`` block by block, on threads or not, gives the bits
    of rounding each whole float32 leaf (``init_params_np``)."""
    cfg = reduced(get_config(ARCH))
    specs = build_specs(cfg)
    want = params_to_torch(specs, init_params_np(specs, 11), "cpu")
    monkeypatch.setattr(common, "_BLOCK_ELEMS", 1000)
    got = init_params(specs, 11, "cpu", threads=threads)
    lw, lg = flatten_specs(want), flatten_specs(got)
    assert [p for p, _ in lw] == [p for p, _ in lg]
    for (p, a), (_, b) in zip(lw, lg):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_scan_bound_at_falcon_mamba_shapes():
    """The scan's bound at falcon-mamba's prefill shapes: one MUFU ``ex2``
    a (token, channel, state) at 16 an SM a clock, 132 SMs at 1.98 GHz."""
    from repro_torch.kernels.selective_scan import bench
    assert bench.FALCON == ((1, 4096, 8192), (2, 4096, 8192))
    assert [c[:3] for c in bench.cases()[1:3]] == list(bench.FALCON)
    for (b, t, di), want in zip(bench.FALCON, (0.128, 0.257)):
        got = bench.scan_bound_ms(b, t, di)
        assert got["limit"] == "MUFU ex2" and round(got["bound_ms"], 3) == want
        assert got["bound_ms"] == pytest.approx(
            b * t * di * 16 / (16 * 132 * 1.98e9) * 1e3, rel=1e-12)


def test_a_0d_leaf_has_no_row_blocks():
    with pytest.raises(ValueError, match="0-d"):
        next(leaf_blocks_np(ParamSpec((), "float32", "zeros"), 0, 0))
    got = init_params({"g": ParamSpec((), "float32", "ones")}, 0, "cpu")
    assert got["g"].shape == () and float(got["g"]) == 1.0
