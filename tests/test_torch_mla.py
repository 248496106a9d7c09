"""The port's MLA blocks (``mla_dense``, ``mla_moe``) against the
reference's, on the CPU.

``reduced(deepseek-v3-671b)``: 4 layers (1 ``mla_dense``, 3
``mla_moe``), width 128, 4 heads, ``MLACfg(64, 32, 32, 16, 32)``
(queries and keys 48 wide, values 32), 8 routed experts, top 2, one
shared expert and the router bias, which both packages get drawn
nonzero here so that the biased choice is exercised.  Parameters come
from the reference's ``init_params`` through ``convert.params_from_jax``;
the reference runs under ``make_test_mesh()`` and its ``Sharder``.
Checked: the specs leaf for leaf (sharding axes included) at full width
and reduced and the full-width parameter count; ``mla_latent``,
``mla_queries``, the expanded prefill attention and the absorbed decode
(its write at ``pos`` clamped to the cache's last slot past the cache,
as the reference's); ``block_apply`` / ``block_decode`` of both kinds;
the whole model's prefill and 4 decode steps with the ``ckv`` / ``kr``
caches; the plain flash attention at ``Dv != Dqk`` against the
reference's ``attention_core``; ``params_from_jax`` on the MLA tree;
``init_params(layers=)`` across two groups; and the CLI.

Tolerances, with reasons (those of ``tests/test_torch_dense.py``): each
bf16 projection is one float32-accumulated product rounded once on both
sides, but sums run in other orders and the reference's compiler may
keep elementwise bf16 chains in float32, so single values flip by one
bf16 ulp.  Logits, of magnitude below 1, agree to 2^-6 (two ulps at the
largest logit); block outputs and caches to 2^-7 of their largest value
(one ulp), an MoE block's output and an MoE model's caches to 2^-6 (a
token near a tie of its router scores moves the others by its softmax
weight, below).
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
from repro.models import attention as jax_attn
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec
from repro.models.model import block_apply as jax_block_apply
from repro.models.model import block_decode as jax_block_decode
from repro.models.model import build_specs as jax_build_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import plan as jax_plan
from repro.models.model import prefill as jax_prefill
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_to_numpy, params_from_jax
from repro_torch.kernels.flash_attention import flash_attention_ref, kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import (block_apply, block_decode, build_specs,
                                      decode_step, plan, prefill)

ARCH = "deepseek-v3-671b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 2 ** -6
REL_TOL = 2 ** -7
# the dense tests' near tie of router logits (tests/test_torch_dense.py),
# on the biased scores sigmoid(logits) + bias: the sigmoid's slope is at
# most 1/4, so a logit difference moves a score by at most a quarter of it
NEAR_TIE = 2 ** -9 / 4
DECODE_STEPS = 4
B, S = 2, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax params, port params, sharder, mesh) of the
    reduced arch, the router bias drawn nonzero in both."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = jax_init_params(jax_build_specs(jcfg), jax.random.PRNGKey(1))
    e = jparams["groups"]["e"]["moe"]
    e["router_bias"] = jnp.asarray(0.05 * np.random.default_rng(7)
                                   .standard_normal(e["router_bias"].shape)
                                   .astype(np.float32))
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    mesh = make_test_mesh()
    return jcfg, cfg, jparams, params, Sharder(mesh), mesh


@pytest.fixture(scope="module")
def jax_run(model):
    """The reference's prefill of 2 prompts of 48 tokens and its 4
    teacher-forced decode steps: (tokens, fed tokens, prefill logits,
    each step's logits, the cache after the prefill and at the end)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1), dtype=np.int32)
    with jax.set_mesh(mesh):
        logits, jcache = jax.jit(lambda p, t: jax_prefill(
            p, {"tokens": t}, jcfg, sh))(jparams, jnp.asarray(toks))
        first = jax.device_get(jcache)
        dec = jax.jit(lambda p, c, t, pos: jax_decode_step(p, c, t, pos,
                                                           jcfg, sh))
        steps = []
        for i in range(DECODE_STEPS):
            out, jcache = dec(jparams, jcache, jnp.asarray(feed[i]),
                              jnp.int32(S + i))
            steps.append(np.asarray(out, np.float32))
    return (toks, feed, np.asarray(logits, np.float32), steps, first,
            jax.device_get(jcache))


def _bf16(rng, shape):
    """A seeded bf16 array and the tensor of the same values."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _close(got, want, tol_share=REL_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol_share * np.abs(want).max())


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _positions(b, s, start=0):
    jpos = jnp.broadcast_to(jnp.arange(start, start + s,
                                       dtype=jnp.int32)[None], (b, s))
    return jpos, torch.arange(start, start + s,
                              dtype=torch.int32).expand(b, s)


# ---------------------------------------------------------------------- #
# configuration and specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cut", [False, True])
def test_specs_equal_the_reference_leaf_for_leaf(cut):
    """Same leaves in the same order with the same shape, dtype, init,
    scale and sharding axes, at full width and reduced; the same plan
    (``mla_dense`` then ``mla_moe``) and parameter count."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    for f in ("dense_layers", "dense_d_ff", "total_layers", "n_heads",
              "n_kv_heads", "head_dim", "vocab_padded"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    ref = jax.tree.flatten_with_path(jax_build_specs(jcfg),
                                     is_leaf=is_spec)[0]
    port = flatten_specs(build_specs(cfg))
    assert ["/".join(k.key for k in kp) for kp, _ in ref] == \
        [p for p, _ in port]
    for (_, r), (_, s) in zip(ref, port):
        assert (tuple(r.shape), r.dtype, r.init, r.scale, tuple(r.axes)) == \
            (tuple(s.shape), s.dtype, s.init, s.scale, tuple(s.axes))
    assert [(g.kind, g.n, g.name) for g in plan(cfg)] == \
        [(g.kind, g.n, g.name) for g in jax_plan(jcfg)]
    assert cfg.param_count() == jcfg.param_count()


def test_full_width_plan_and_parameter_count():
    """DeepSeek-V3 at full width: 3 ``mla_dense`` layers of ``dense_d_ff``
    18,432 and 58 ``mla_moe`` layers, 671.0 B parameters as the
    reference counts them; its first 4 layers and the embeddings hold
    15.11 B."""
    cfg = get_config(ARCH)
    assert [(g.kind, g.n) for g in plan(cfg)] == [("mla_dense", 3),
                                                  ("mla_moe", 58)]
    assert cfg.param_count() == jax_get_config(ARCH).param_count() == \
        671_026_419_200
    specs = build_specs(cfg)
    assert specs["groups"]["d"]["mlp"]["wi"].shape == (3, 7168, 2, 18432)
    assert specs["groups"]["e"]["moe"]["wi"].shape == (58, 256, 7168, 2,
                                                       2048)
    assert specs["groups"]["e"]["attn"]["wq_b"].shape == (58, 1536, 128, 192)
    keep = common.group_rows(specs, 4)
    assert keep == {"d": 3, "e": 1}
    first4 = sum(int(np.prod((keep[p.split("/")[1]], *s.shape[1:])))
                 if p.startswith("groups/") else int(np.prod(s.shape))
                 for p, s in flatten_specs(specs))
    assert first4 == pytest.approx(15.11e9, rel=1e-3)


def test_params_from_jax_carries_the_mla_tree(model):
    """Every leaf of the reference's MLA tree, bit for bit, in the
    port's layout."""
    jcfg, cfg, jparams, params, sh, mesh = model
    want = jax.tree.flatten_with_path(jax.device_get(jparams))[0]
    got = dict(flatten_specs(params))
    assert len(got) == len(want)
    for kp, w in want:
        t = got["/".join(k.key for k in kp)]
        w = np.asarray(w)
        assert tuple(t.shape) == w.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      w.astype(np.float32))
    assert set(params["groups"]["d"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #
def test_latent_and_queries_match_the_reference(model):
    jcfg, cfg, jparams, params, sh, mesh = model
    jp = _layer(jparams["groups"]["d"]["attn"], 0)
    p = _layer(params["groups"]["d"]["attn"], 0)
    jx, x = _bf16(np.random.default_rng(11), (B, 40, cfg.d_model))
    jpos, pos = _positions(B, 40)
    want = jax.jit(lambda p, x: (jax_attn.mla_latent(p, x, jcfg, jpos),
                                 jax_attn.mla_queries(p, x, jcfg, jpos)))(
        jp, jx)
    got = (attn.mla_latent(p, x, cfg, pos), attn.mla_queries(p, x, cfg, pos))
    m = cfg.mla
    shapes = [((B, 40, m.kv_lora), (B, 40, m.rope_dim)),
              ((B, 40, 4, m.nope_dim), (B, 40, 4, m.rope_dim))]
    for g2, w2, sh2 in zip(got, want, shapes):
        for g, w, s in zip(g2, w2, sh2):
            assert tuple(g.shape) == s and g.dtype == torch.bfloat16
            _close(g, w)


def test_prefill_attention_matches_the_reference(model):
    """The expanded form: q and k 48 wide, v 32, through the plain flash
    attention, against the reference's ``mla_attention_train`` (its
    ``attention_core`` takes ``Dv != D``)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    jp = _layer(jparams["groups"]["e"]["attn"], 0)
    p = _layer(params["groups"]["e"]["attn"], 0)
    jx, x = _bf16(np.random.default_rng(12), (B, 70, cfg.d_model))
    jpos, pos = _positions(B, 70)
    want, (jckv, jkr) = jax.jit(lambda p, x: jax_attn.mla_attention_train(
        p, x, jcfg, jpos, 64, 64))(jp, jx)
    q, k, v, ckv, kr = attn.mla_qkv(p, x, cfg, pos)
    m = cfg.mla
    assert q.shape == k.shape == (B, 70, 4, m.nope_dim + m.rope_dim)
    assert v.shape == (B, 70, 4, m.v_dim)
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    # every head's rope part of k is the one shared rotated key
    assert torch.equal(k[..., m.nope_dim:], kr[:, :, None].expand(
        B, 70, 4, m.rope_dim))
    got = attn.mla_out(p, flash_attention_ref(q, k, v))
    _close(got, want)
    _close(ckv, jckv)
    _close(kr, jkr)


@pytest.mark.parametrize("S0", [24, 30])
def test_absorbed_decode_matches_the_reference(model, S0):
    """4 steps of the absorbed decode on a 30-slot latent cache from
    position ``S0``: from 24 the writes land in slots 24-27, from 30 they
    are clamped to the last slot (the reference's
    ``dynamic_update_slice``), and the scores mask slots past ``pos``."""
    jcfg, cfg, jparams, params, sh, mesh = model
    jp = _layer(jparams["groups"]["e"]["attn"], 1)
    p = _layer(params["groups"]["e"]["attn"], 1)
    rng = np.random.default_rng(13 + S0)
    m = cfg.mla
    jckv, ckv = _bf16(rng, (B, 30, m.kv_lora))
    jkr, kr = _bf16(rng, (B, 30, m.rope_dim))
    ckv0 = ckv.clone()
    dec = jax.jit(lambda p, x, c, r, pos: jax_attn.mla_attention_decode(
        p, x, jcfg, c, r, pos))
    for i in range(4):
        jx, x = _bf16(rng, (B, 1, cfg.d_model))
        want, jckv, jkr = dec(jp, jx, jckv, jkr, jnp.int32(S0 + i))
        got = attn.mla_decode(p, x, cfg, ckv, kr, S0 + i)
        assert got.shape == (B, 1, cfg.d_model)
        _close(got, want)
        _close(ckv, jckv)
        _close(kr, jkr)
    changed = (ckv != ckv0).any(-1).any(0).nonzero().flatten().tolist()
    assert changed == ([24, 25, 26, 27] if S0 == 24 else [29])


@pytest.mark.parametrize("Sq,Skv,H", [(128, 128, 4), (77, 77, 4),
                                      (77, 333, 8), (130, 200, 2)])
def test_plain_flash_attention_with_narrower_values(Sq, Skv, H):
    """``flash_attention_ref`` with queries and keys 192 wide and values
    128 wide (MLA's, group 1), square and ragged ``Sq`` (77 and 130 are
    not multiples of 64), against the reference's ``attention_core``
    with the queries at the end of the keys: within the bf16 rule of
    ``tests/test_torch_flash_attention.py`` (2^-6 of the largest
    output); the output is ``Dv`` wide, and ``compare_bf16`` passes the
    plain version against itself."""
    rng = np.random.default_rng(Sq + Skv)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, s) for s in (
        (1, Sq, H, 192), (1, Skv, H, 192), (1, Skv, H, 128)))
    want = jax_attn.attention_core(jq, jk, jv, causal=True, q_block=64,
                                   kv_block=64, q_offset=Skv - Sq)
    got = flash_attention_ref(q, k, v)
    assert got.shape == (1, Sq, H, 128)
    _close(got, want, 2 ** -6)
    cmp = fa_ref.compare_bf16(got, got, q, k, v)
    assert cmp["ok"] and cmp["n_allowed"] >= 2 * 128


def test_shapes_and_head_dims_of_the_kernel():
    """The kernel is built for (192, 128); the plain version refuses
    values that do not match the keys' batch, length or heads."""
    assert (192, 128) in kernel.HEAD_DIMS
    assert (128, 128) in kernel.HEAD_DIMS and (192, 192) not in \
        kernel.HEAD_DIMS
    q = torch.zeros(1, 8, 2, 192, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 192, dtype=torch.bfloat16)
    fa_ref.check_shapes(q, k, torch.zeros(1, 8, 2, 128))
    for bad in ((1, 8, 1, 128), (1, 9, 2, 128), (2, 8, 2, 128)):
        with pytest.raises(ValueError, match="Dv"):
            fa_ref.check_shapes(q, k, torch.zeros(bad))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, torch.zeros(1, 8, 2, 128,
                                                 dtype=torch.bfloat16))


def test_bench_mla_cases_and_bound():
    """The first MLA case is DeepSeek's prefill layer, ``[2, 4096, 128,
    192 / 128]``: 2 x 128 x 8,390,656 live pairs x 2 (192 + 128) =
    1.375e12 operations, 1.390 ms at 989 TFLOP/s; the second, also timed,
    has ``Sq`` not a multiple of 64, and every case is group 1."""
    from repro_torch.kernels.flash_attention import bench
    assert bench.CASES_MLA[0] == (2, 4096, 4096, 128, 128, 192, None, 128)
    assert bench.CASES_MLA[1][1] % 64 and \
        bench.CASES_MLA[1][1] == bench.CASES_MLA[1][2]
    assert all(c[3] == c[4] and (c[5], c[7]) == (192, 128)
               for c in bench.CASES_MLA)
    assert fa_ref.live_pairs(4096, 4096) == 8_390_656
    ops = 2 * 128 * 8_390_656 * 2 * (192 + 128)
    assert ops == pytest.approx(1.375e12, rel=1e-3)
    ms, by = bench.bound_ms(*bench.CASES_MLA[0])
    assert by == "operations" and ms == pytest.approx(1.390, abs=5e-4)
    assert ms == pytest.approx(ops / bench.BF16_OPS_PER_S * 1e3)


# ---------------------------------------------------------------------- #
# blocks and the whole model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("group,layer", [("d", 0), ("e", 1)])
def test_block_apply_and_decode_match_the_reference(model, group, layer):
    """One layer of each MLA kind: the prefill block's output and its
    ``ckv`` / ``kr`` cache, then 3 decode steps against that cache (the
    write past the cache clamped to its last slot)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    kind = {g.name: g.kind for g in plan(cfg)}[group]
    jp = _layer(jparams["groups"][group], layer)
    p = _layer(params["groups"][group], layer)
    rng = np.random.default_rng(4)
    jx, x = _bf16(rng, (B, 40, cfg.d_model))
    jpos, pos = _positions(B, 40)
    with jax.set_mesh(mesh):
        want, jcache = jax.jit(lambda p, x: jax_block_apply(
            kind, p, x, jcfg, sh, jpos))(jp, jx)
    got, cache = block_apply(kind, p, x, cfg, pos)
    tol = REL_TOL if kind == "mla_dense" else 2 * REL_TOL
    _close(got, want, tol)
    assert cache.keys() == jcache.keys() == {"ckv", "kr"}
    for key in cache:
        _close(cache[key], jcache[key])
    dec = jax.jit(lambda p, x, c, pos: jax_block_decode(kind, p, x, jcfg,
                                                        sh, c, pos))
    for i in range(3):
        jx, x = _bf16(rng, (B, 1, cfg.d_model))
        with jax.set_mesh(mesh):
            want, jcache = dec(jp, jx, jcache, jnp.int32(40 + i))
        got = block_decode(kind, p, x, cfg, cache, 40 + i)
        _close(got, want, tol)
    for key in cache:
        _close(cache[key], jcache[key])


def test_prefill_and_decode_match_the_reference(model, jax_run, monkeypatch):
    """Prefill of 2 prompts of 48 tokens, then 4 teacher-forced decode
    steps: the logits at every position, and the ``ckv`` / ``kr`` caches
    after the prefill and at the end (each step's write clamped to the
    prompt's last slot).

    A token whose top-k boundary is a near tie of its biased router
    scores (the gap between its k-th and (k+1)-th below ``NEAR_TIE``) may
    take another expert in the port than in the reference; its latent
    in the later layers is not held, and the others are held to two
    ulps (2^-6); near ties stay rare (at most a tenth of the tokens)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    toks, feed, want, steps, first, last = jax_run
    scores = []
    route = moe.route

    def seen(p, logits, m):
        scores.append(torch.sigmoid(logits) + p["router_bias"])
        return route(p, logits, m)
    monkeypatch.setattr(moe, "route", seen)
    logits, cache = prefill(params, torch.from_numpy(toks), cfg)
    assert len(scores) == 3                 # the mla_moe layers, in order
    tied = np.zeros((B, S), bool)
    for sc in scores:
        top = sc.sort(-1, descending=True).values
        k = cfg.moe.top_k
        tied |= (top[:, k - 1] - top[:, k] < NEAR_TIE).reshape(B, S).numpy()
    assert tied.sum() <= 0.1 * tied.size
    assert logits.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)

    def held(got, want, tol):
        assert got.keys() == want.keys() == {"d", "e"}
        for g in want:
            assert got[g].keys() == want[g].keys() == {"ckv", "kr"}
            for key, w in want[g].items():
                w = np.asarray(w, np.float32)
                assert got[g][key].shape == w.shape
                _close(got[g][key][:, ~tied], w[:, ~tied],
                       tol if g == "d" else 2 * tol)
    held(cache_to_numpy(cache), first, REL_TOL)
    m = cfg.mla
    assert cache["d"]["ckv"].shape == (1, B, S, m.kv_lora)
    assert cache["e"]["kr"].shape == (3, B, S, m.rope_dim)
    for i in range(DECODE_STEPS):
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    S + i, cfg)
        np.testing.assert_allclose(logits.float().numpy(), steps[i],
                                   rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
    held(cache_to_numpy(cache), last, REL_TOL)
    # every step wrote the prompt's last slot, the reference's clamp
    before = np.asarray(first["d"]["ckv"], np.float32)
    after = np.asarray(last["d"]["ckv"], np.float32)
    np.testing.assert_array_equal(after[:, :, :-1], before[:, :, :-1])
    assert not np.array_equal(after[:, :, -1], before[:, :, -1])


# ---------------------------------------------------------------------- #
# weights cut in depth, and the CLI
# ---------------------------------------------------------------------- #
def test_init_params_cuts_the_first_layers_across_groups(monkeypatch):
    """``init_params(layers=2)`` keeps the model's first 2 layers: the one
    ``mla_dense`` layer and the first ``mla_moe`` layer, each stacked
    leaf's rows as the whole draw has them, every other leaf whole."""
    cfg = reduced(get_config(ARCH))
    specs = build_specs(cfg)
    monkeypatch.setattr(common, "_BLOCK_ELEMS", 1000)
    whole = common.init_params(specs, 4, "cpu")
    cut = common.init_params(specs, 4, "cpu", threads=2, layers=2)
    keep = common.group_rows(specs, 2)
    assert keep == {"d": 1, "e": 1}
    for (path, a), (_, b) in zip(flatten_specs(whole), flatten_specs(cut)):
        want = a[:keep[path.split("/")[1]]] if path.startswith("groups/") \
            else a
        assert b.dtype == a.dtype and torch.equal(b, want), path
    assert common.group_rows(specs, None) == {"d": 1, "e": 3}


def test_cli_serves_the_reduced_deepseek_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "16", "--max-new", "3"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arch"] == f"{ARCH}-smoke" and out["generated"] == [2, 3]
    from repro_torch.launch.serve import ServeSession
    cfg = reduced(get_config(ARCH))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16),
                                                dtype=np.int32)
    want = ServeSession(cfg, device="cpu").generate(prompts, 3)
    assert out["sample"] == want[0].tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("Bq,Sq,Skv,H", [(1, 256, 256, 8), (2, 77, 333, 4),
                                         (1, 130, 130, 16)])
def test_cuda_kernel_matches_plain_version_at_mla_dims(Bq, Sq, Skv, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(Sq)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               .to(torch.bfloat16) for s in ((Bq, Sq, H, 192),
                                             (Bq, Skv, H, 192),
                                             (Bq, Skv, H, 128)))
    got = kernel.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (Bq, Sq, H, 128)
    assert fa_ref.compare_bf16(got, want, q, k, v)["ok"]
