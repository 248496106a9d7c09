"""The port's ``dense`` block and MLPs against the reference's, on the CPU.

The reference's ``reduced`` configs of the dense architectures —
``qwen3-1.7b`` (SwiGLU, qk-norm), ``nemotron-4-15b`` (squared ReLU),
``starcoder2-15b`` (tanh GELU), ``command-r-plus-104b`` (SwiGLU, RoPE θ
7.5e7) — and of ``qwen3-moe-235b-a22b`` for the ``moe`` block (its
routing is held in ``tests/test_torch_moe.py``): 4 layers, width 128, 4
query heads on 2 KV heads of 32.  Parameters come from the reference's
``init_params`` through ``convert.params_from_jax``; the reference runs
under ``make_test_mesh()`` and its ``Sharder``.  Checked: every MLP
activation, ``block_apply`` and ``block_decode`` of both kinds, the
whole model's prefill and 4 teacher-forced decode steps, the specs leaf
for leaf (sharding axes included) at full width and reduced, and the
plain flash attention at head dim 128 (GQA groups 2 and 16, the two
Qwen3 models') against the reference's ``attention_core``.

Tolerances, with reasons (those of ``tests/test_torch_hymba.py``): each
bf16 projection is one float32-accumulated product rounded once on both
sides, but sums run in other orders and the reference's compiler may
keep elementwise bf16 chains in float32, so single values flip by one
bf16 ulp.  Logits, of magnitude below 1, agree to 2^-6 (two ulps at the
largest logit); block outputs and caches to 2^-7 of their largest value
(one ulp).  An MLP's output, one rounding after a product of rounded
inputs, agrees to 2^-7 of its largest value.  ``jax.nn.gelu`` is the
tanh form; the port's agrees with it to 1e-5 relative and 1e-6 absolute
(past -5 the reference's ``1 + tanh`` cancels to 0 where torch keeps
values of about 3e-7), and differs from the erf form that ``torch``'s
default gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh
from repro.models import common as jax_common
from repro.models.attention import attention_core
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec
from repro.models.model import block_apply as jax_block_apply
from repro.models.model import block_decode as jax_block_decode
from repro.models.model import build_specs as jax_build_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import prefill as jax_prefill
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_to_numpy, params_from_jax
from repro_torch.kernels.flash_attention import flash_attention_ref, kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import common, moe
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import (block_apply, block_decode, build_specs,
                                      decode_step, plan, prefill)

LOGIT_TOL = 2 ** -6
REL_TOL = 2 ** -7
# a router-score gap that one-ulp differences of the router's input can
# close: a few bf16 ulps (2^-8 of values about 1) times weights of 0.02,
# summed over width 128, with a margin
NEAR_TIE = 2 ** -9
DECODE_STEPS = 4
DENSE = ("qwen3-1.7b", "nemotron-4-15b", "starcoder2-15b",
         "command-r-plus-104b")
ARCHS = DENSE + ("qwen3-moe-235b-a22b",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    """(jax cfg, port cfg, jax params, port params, sharder, mesh) of the
    reduced arch, built once per worker."""
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch))
        cfg = reduced(get_config(arch))
        jparams = jax_init_params(jax_build_specs(jcfg),
                                  jax.random.PRNGKey(1))
        params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
        mesh = make_test_mesh()
        _MODELS[arch] = (jcfg, cfg, jparams, params, Sharder(mesh), mesh)
    return _MODELS[arch]


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


# ---------------------------------------------------------------------- #
# activations and MLPs
# ---------------------------------------------------------------------- #
def test_activations_match_the_reference_near_zero_and_in_the_tails():
    x = np.concatenate([np.linspace(-1e-3, 1e-3, 201),
                        np.linspace(-12, -5, 141), np.linspace(5, 12, 141),
                        np.random.default_rng(0).standard_normal(1000) * 3]
                       ).astype(np.float32)
    t = torch.from_numpy(x)
    for name in ("gelu", "relu", "silu", "sq_relu"):
        want = np.asarray(jax_common.activation(name)(jnp.asarray(x)))
        got = common.activation(name)(t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name in ("swiglu", "geglu"):
        want = np.asarray(jax_common.GATED_ACTS[name](jnp.asarray(x)))
        got = common.GATED_ACTS[name](t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        with pytest.raises(ValueError, match="gated"):
            common.activation(name)
    # the erf form differs from the reference's tanh form at this size
    erf = torch.nn.functional.gelu(t).numpy()
    assert np.abs(erf - common.activation("gelu")(t).numpy()).max() > 1e-4


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu", "silu",
                                 "sq_relu"])
def test_mlp_matches_the_reference(act):
    jspecs = jax_common.mlp_specs(128, 256, act, 0.01)
    specs = common.mlp_specs(128, 256, act, 0.01)
    assert flatten_specs(specs) and [
        (p, tuple(s.shape), tuple(s.axes)) for p, s in flatten_specs(specs)] \
        == [(p, tuple(s.shape), tuple(s.axes))
            for p, s in flatten_specs(jspecs)]
    jp = jax_common.init_params(jspecs, jax.random.PRNGKey(2))
    p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
         for k, v in jp.items()}
    jx, x = _bf16(np.random.default_rng(3), (2, 24, 128))
    want = jax.jit(lambda p, x: jax_common.mlp_apply(p, x, act))(jp, jx)
    got = common.mlp_apply(p, x, act)
    assert got.dtype == torch.bfloat16
    _close(got, want)


# ---------------------------------------------------------------------- #
# specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_leaf_for_leaf(arch, cut):
    """Same leaves in the same order with the same shape, dtype, init,
    scale and sharding axes, at full width and reduced; the same plan,
    parameter count and ``supports``."""
    from repro.configs import supports as jax_supports
    from repro_torch.configs import supports
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    for f in ("dense_layers", "dense_d_ff", "total_layers", "act",
              "n_layers", "d_ff", "vocab_padded", "sub_quadratic"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    ref = jax.tree.flatten_with_path(jax_build_specs(jcfg),
                                     is_leaf=is_spec)[0]
    port = flatten_specs(build_specs(cfg))
    assert ["/".join(k.key for k in kp) for kp, _ in ref] == \
        [p for p, _ in port]
    for (_, r), (_, s) in zip(ref, port):
        assert (tuple(r.shape), r.dtype, r.init, r.scale, tuple(r.axes)) == \
            (tuple(s.shape), s.dtype, s.init, s.scale, tuple(s.axes))
    from repro.models.model import plan as jax_plan
    assert [(g.kind, g.n, g.name) for g in plan(cfg)] == \
        [(g.kind, g.n, g.name) for g in jax_plan(jcfg)]
    assert cfg.param_count() == jcfg.param_count()
    for shape in ("train_4k", "long_500k"):
        assert supports(cfg, shape) == jax_supports(jcfg, shape)


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "nemotron-4-15b",
                                  "qwen3-moe-235b-a22b"])
def test_block_apply_and_decode_match_the_reference(arch):
    """One layer of the arch's block kind: the prefill block's output and
    cache, then 3 decode steps against that cache (the write at ``pos``
    past the cache is clamped to its last slot, as the reference's)."""
    jcfg, cfg, jparams, params, sh, mesh = _model(arch)
    g = plan(cfg)[0]
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][g.name])
    p = jax.tree.map(lambda t: t[1], params["groups"][g.name])
    B, S = 2, 40
    rng = np.random.default_rng(4)
    jx, x = _bf16(rng, (B, S, cfg.d_model))
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    with jax.set_mesh(mesh):
        want, jcache = jax.jit(lambda p, x: jax_block_apply(
            g.kind, p, x, jcfg, sh, jpos))(jp, jx)
    got, cache = block_apply(g.kind, p, x, cfg,
                             torch.arange(S, dtype=torch.int32).expand(B, S))
    _close(got, want)
    assert cache.keys() == jcache.keys() == {"k", "v"}
    for key in cache:
        _close(cache[key], jcache[key])
    dec = jax.jit(lambda p, x, c, pos: jax_block_decode(g.kind, p, x, jcfg,
                                                        sh, c, pos))
    for i in range(3):
        jx, x = _bf16(rng, (B, 1, cfg.d_model))
        with jax.set_mesh(mesh):
            want, jcache = dec(jp, jx, jcache, jnp.int32(S + i))
        got = block_decode(g.kind, p, x, cfg, cache, S + i)
        _close(got, want)
    for key in cache:
        _close(cache[key], jcache[key])


# ---------------------------------------------------------------------- #
# the whole reduced model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, monkeypatch):
    """Prefill of 2 prompts of 48 tokens, then 4 teacher-forced decode
    steps: the logits at every position and the whole cache at the end.

    In an MoE model a token whose top-k boundary is a near tie (the gap
    between its k-th and (k+1)-th router score below ``NEAR_TIE``) may
    take another expert in the port than in the reference: the router's
    input carries the one-ulp bf16 differences of the layers before it.
    Such a token's keys and values in the later layers are not held; it
    also moves the other tokens' attention outputs by its softmax weight
    (about 1/S) times its own change, so in an MoE model the other
    positions are held to two ulps of the largest value (2^-6) where a
    dense model's are held to one; near ties stay rare (at most a tenth
    of the tokens)."""
    jcfg, cfg, jparams, params, sh, mesh = _model(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 48), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, 2, 1), dtype=np.int32)
    with jax.set_mesh(mesh):
        want, jcache = jax.jit(lambda p, t: jax_prefill(
            p, {"tokens": t}, jcfg, sh))(jparams, jnp.asarray(toks))
    scores = []
    router = moe.router_logits
    monkeypatch.setattr(moe, "router_logits",
                        lambda *a: scores.append(router(*a)) or scores[-1])
    logits, cache = prefill(params, torch.from_numpy(toks), cfg)
    tied = np.zeros((2, 48), bool)
    for sc in scores:                   # one [T, E] a layer, in order
        top = sc.sort(-1, descending=True).values
        k = cfg.moe.top_k
        tied |= (top[:, k - 1] - top[:, k] < NEAR_TIE).reshape(2, 48).numpy()
    assert len(scores) == (cfg.n_layers if cfg.moe else 0)
    assert tied.sum() <= 0.1 * tied.size
    assert logits.shape == (2, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LOGIT_TOL)
    dec = jax.jit(lambda p, c, t, pos: jax_decode_step(p, c, t, pos, jcfg,
                                                       sh))
    for i in range(DECODE_STEPS):
        with jax.set_mesh(mesh):
            want, jcache = dec(jparams, jcache, jnp.asarray(feed[i]),
                               jnp.int32(48 + i))
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    48 + i, cfg)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {i}")
    got, want = cache_to_numpy(cache), jax.device_get(jcache)
    assert got.keys() == want.keys()
    held = np.ones(48 + DECODE_STEPS, bool)[None].repeat(2, 0)
    held[:, :48] = ~tied
    for gname in want:
        assert got[gname].keys() == want[gname].keys() == {"k", "v"}
        for key, w in want[gname].items():
            w = np.asarray(w, np.float32)
            _close(got[gname][key][:, held[:, :w.shape[2]]],
                   w[:, held[:, :w.shape[2]]],
                   REL_TOL if cfg.moe is None else 2 * REL_TOL)


# ---------------------------------------------------------------------- #
# attention at head dim 128
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,Hkv", [(2, 200, 16, 8), (1, 160, 64, 4)])
def test_plain_flash_attention_at_head_dim_128(B, S, H, Hkv):
    """GQA groups 2 (qwen3-1.7b) and 16 (qwen3-moe-235b-a22b) at D = 128,
    bf16, against the model's ``attention_core``: within the bf16 rule of
    ``tests/test_torch_flash_attention.py`` (2^-6 of the largest
    output), and the kernel's check ``compare_bf16`` passes the plain
    version against itself."""
    rng = np.random.default_rng(S)
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, s) for s in (
        (B, S, H, 128), (B, S, Hkv, 128), (B, S, Hkv, 128)))
    want = attention_core(jq, jk, jv, causal=True, q_block=64, kv_block=64)
    got = flash_attention_ref(q, k, v)
    _close(got, want, 2 ** -6)
    assert (128, 128) in kernel.HEAD_DIMS
    assert fa_ref.compare_bf16(got, got, q, k, v)["ok"]


@pytest.mark.parametrize("sq,skv,window", [(4096, 4096, None),
                                           (1000, 1100, 300), (77, 333, None)])
def test_key_tiles_at_head_dim_128_cover_the_mask_once(sq, skv, window):
    """The D = 128 cases' tile schedule (``bench.CASES_D128``): the key
    tiles each query tile visits hold every live pair once, and none is
    wholly masked (the schedule does not depend on D)."""
    from repro_torch.kernels.flash_attention import bench
    assert (sq, skv, window) in {(c[1], c[2], c[6])
                                 for c in bench.CASES_D128}
    live = fa_ref._mask(sq, skv, window, "cpu").numpy()
    seen = np.zeros(live.shape, np.int16)
    for qt, t_lo, t_hi in kernel.key_tiles(sq, skv, window):
        rows = slice(qt * kernel.BLOCK_Q, min((qt + 1) * kernel.BLOCK_Q, sq))
        for t in range(t_lo, t_hi + 1):
            cols = slice(t * fa_ref.BLOCK_K, min((t + 1) * fa_ref.BLOCK_K,
                                                 skv))
            assert live[rows, cols].any()
            seen[rows, cols] += 1
    assert (seen[live] == 1).all()


def test_bench_d128_cases_and_bounds():
    """The two timed D = 128 cases are the Qwen3 prefill layers, and
    their bounds are 4 D operations a live pair at 989 TFLOP/s: 2.75e11
    operations (0.278 ms) and 5.50e11 (0.556 ms)."""
    from repro_torch.kernels.flash_attention import bench
    assert bench.CASES_D128[:2] == [(4, 4096, 4096, 16, 8, 128, None),
                                    (2, 4096, 4096, 64, 4, 128, None)]
    for case, ops, ms in zip(bench.CASES_D128, (2.75e11, 5.50e11),
                             (0.278, 0.556)):
        b, sq, skv, h = case[:4]
        n = 4 * 128 * b * h * fa_ref.live_pairs(sq, skv)
        assert n == pytest.approx(ops, rel=2e-3)
        assert bench.bound_ms(*case) == (pytest.approx(ms, abs=5e-4),
                                         "operations")


# ---------------------------------------------------------------------- #
# weight synthesis cut in depth
# ---------------------------------------------------------------------- #
def test_init_params_keeps_the_first_layers(monkeypatch):
    """``init_params(layers=2)`` of the full-depth specs gives the first
    two layers of every stacked leaf of the whole draw, and every other
    leaf whole: the Qwen3 MoE cut in depth at its full model's scales."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    specs = build_specs(cfg)
    monkeypatch.setattr(common, "_BLOCK_ELEMS", 1000)
    whole = common.init_params(specs, 4, "cpu")
    cut = common.init_params(specs, 4, "cpu", threads=2, layers=2)
    for (path, a), (_, b) in zip(flatten_specs(whole), flatten_specs(cut)):
        want = a[:2] if path.startswith("groups/") else a
        assert b.dtype == a.dtype and torch.equal(b, want), path
