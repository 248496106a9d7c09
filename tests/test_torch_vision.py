"""The port's vision super-block (``vision_super``) against the
reference's, on the CPU.

``reduced(llama-3.2-vision-90b)``: 4 layers as 2 super-blocks of 1 self
layer and 1 gated cross layer, width 128, 4 query heads on 2 KV heads of
32, SwiGLU ``d_ff`` 256, vocab 512, 16 vision tokens a request.
Parameters come from the reference's ``init_params`` through
``convert.params_from_jax``, with both gates of every super-block set to
1.0 in both packages: the init draws them as zeros, and ``tanh(0) = 0``
would make the cross layer add nothing, so that a wrong cross-attention
would pass.  The reference runs under ``make_test_mesh()`` and its
``Sharder``.  Checked: the specs leaf for leaf (the ``self`` leaves
stacked twice, the float32 scalar gates) at full width and reduced, the
full-width parameter count and the first super-block's; the nested
tree through ``params_from_jax``; ``block_apply`` and 3 ``block_decode``
steps of one super-block with its ``k`` / ``v`` / ``ck`` / ``cv``
caches; the whole model's prefill, every cache leaf and 4 decode steps;
that the gates open the cross layer; ``ServeSession.generate`` over a
context; and the refusals of a missing or stray context.

Tolerances, with the reasons of ``tests/test_torch_dense.py``: each bf16
projection is one float32-accumulated product rounded once on both
sides, but sums run in other orders and the reference's compiler may
keep elementwise bf16 chains (the gate's product and the residual among
them) in float32, so single values flip by one bf16 ulp.  Logits, of
magnitude below 1, agree to 2^-6 (two ulps at the largest logit); block
outputs and caches to 2^-7 of their largest value (one ulp).  Greedy
tokens may differ only at a near tie of the reference's top two logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh
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
from repro_torch.launch.serve import ServeSession
from repro_torch.models import common
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import (block_apply, block_decode, build_specs,
                                      decode_step, plan, prefill)

ARCH = "llama-3.2-vision-90b"
LOGIT_TOL = 2 ** -6
REL_TOL = 2 ** -7
DECODE_STEPS = 4
GATE = 1.0
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def open_gates(jparams, group: str, keys):
    """The reference's tree with the float32 gates ``keys`` of ``group``
    set to ``GATE`` (a new tree)."""
    g = jparams["groups"][group]
    sub = {**g["cross"], **{k: jnp.full_like(g["cross"][k], GATE)
                            for k in keys}}
    return {**jparams, "groups": {**jparams["groups"],
                                  group: {**g, "cross": sub}}}


def reference_model(arch: str, seed: int, edit=None):
    """(jax cfg, port cfg, jax params, port params, sharder, mesh) of the
    reduced ``arch``, the reference's tree through ``edit``."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jax_init_params(jax_build_specs(jcfg),
                              jax.random.PRNGKey(seed))
    if edit is not None:
        jparams = edit(jparams)
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    mesh = make_test_mesh()
    return jcfg, cfg, jparams, params, Sharder(mesh), mesh


def bf16(rng, shape, scale=1.0):
    """A seeded bf16 array and the tensor of the same values."""
    a = jnp.asarray((scale * rng.standard_normal(shape)).astype(
        np.float32)).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def close(got, want, tol_share=REL_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol_share * np.abs(want).max())


def positions(b, s, start=0):
    jpos = jnp.broadcast_to(jnp.arange(start, start + s,
                                       dtype=jnp.int32)[None], (b, s))
    return jpos, torch.arange(start, start + s,
                              dtype=torch.int32).expand(b, s)


def specs_equal(jcfg, cfg) -> None:
    """Same leaves in the same order with the same shape, dtype, init,
    scale and sharding axes; the same plan and parameter count."""
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
    for f in ("total_layers", "cross_every", "n_ctx_tokens", "enc_dec",
              "enc_layers", "vocab_padded"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()


def generate_matches(models, toks, ctx_np, max_new, jax_steps) -> None:
    """Greedy tokens of the port's ``ServeSession.generate`` over a
    context against the reference's greedy path (its jitted prefill and
    decode steps, as its ``ServeSession.generate`` runs them), up to the
    first difference, which may only come at a near tie of the
    reference's top two logits."""
    jcfg, cfg, jparams, params, sh, mesh = models
    S0 = toks.shape[1]
    want, margins = [], []
    with jax.set_mesh(mesh):
        logits, cache = jax_steps[0](jparams, jnp.asarray(toks),
                                     jnp.asarray(ctx_np, jnp.bfloat16))
        for i in range(max_new):
            last = np.asarray(logits[:, -1, :jcfg.vocab], np.float32)
            top2 = np.sort(last, axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            want.append(last.argmax(-1).astype(np.int32))
            if i + 1 < max_new:
                logits, cache = jax_steps[1](
                    jparams, cache, jnp.asarray(want[-1][:, None]),
                    jnp.int32(S0 + i))
    want = np.stack(want, 1)
    got = ServeSession(cfg, params=params, device="cpu").generate(
        toks, max_new, ctx_np)
    assert got.shape == want.shape == (toks.shape[0], max_new)
    assert got.dtype == np.int32
    for row in range(toks.shape[0]):
        for i in range(max_new):
            if got[row, i] != want[row, i]:
                assert margins[i][row] <= 2 * LOGIT_TOL, (row, i)
                break


def jax_steps_of(jcfg, sh):
    """The reference's jitted prefill (tokens, ctx) and decode step."""
    return (jax.jit(lambda p, t, c: jax_prefill(p, {"tokens": t, "ctx": c},
                                                jcfg, sh)),
            jax.jit(lambda p, c, t, pos: jax_decode_step(p, c, t, pos, jcfg,
                                                         sh)))


@pytest.fixture(scope="module")
def model():
    return reference_model(ARCH, 1, lambda p: open_gates(
        p, "vs", ("gate_attn", "gate_mlp")))


@pytest.fixture(scope="module")
def jax_run(model):
    """The reference's prefill of 2 prompts of 24 tokens over 16 vision
    tokens and its 4 teacher-forced decode steps: (tokens, context, fed
    tokens, prefill logits, each step's logits, the cache after the
    prefill and at the end, the jitted steps)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    ctx = rng.standard_normal((B, cfg.n_ctx_tokens, cfg.d_model))
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1), dtype=np.int32)
    steps_fn = jax_steps_of(jcfg, sh)
    with jax.set_mesh(mesh):
        logits, jcache = steps_fn[0](jparams, jnp.asarray(toks),
                                     jnp.asarray(ctx, jnp.bfloat16))
        first = jax.device_get(jcache)
        steps = []
        for i in range(DECODE_STEPS):
            out, jcache = steps_fn[1](jparams, jcache, jnp.asarray(feed[i]),
                                      jnp.int32(S + i))
            steps.append(np.asarray(out, np.float32))
    return (toks, ctx, feed, np.asarray(logits, np.float32), steps, first,
            jax.device_get(jcache), steps_fn)


def _ctx(ctx_np):
    return torch.from_numpy(np.asarray(ctx_np, np.float32)).to(
        torch.bfloat16)


# ---------------------------------------------------------------------- #
# configuration and specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cut", [False, True])
def test_specs_equal_the_reference_leaf_for_leaf(cut):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    specs_equal(jcfg, cfg)


def test_full_width_plan_and_first_super_block():
    """20 super-blocks of 4 self layers and 1 gated cross layer: 87.7 B
    parameters as the reference counts them; the first super-block and
    the embeddings (``group_rows`` of 1 row) hold 6.38 B; the self leaves
    are stacked ``[20, 4, ...]``, the gates float32 zeros ``[20]``; the
    output projections' scale is ``0.02 / sqrt(200)``."""
    cfg = get_config(ARCH)
    assert [(g.kind, g.n) for g in plan(cfg)] == [("vision_super", 20)]
    assert cfg.param_count() == jax_get_config(ARCH).param_count() == \
        87_666_794_536
    specs = build_specs(cfg)
    vs = specs["groups"]["vs"]
    assert vs["self"]["mlp"]["wi"].shape == (20, 4, 8192, 2, 28672)
    assert vs["cross"]["attn"]["wk"].shape == (20, 8192, 8, 128)
    for g in ("gate_attn", "gate_mlp"):
        assert (vs["cross"][g].shape, vs["cross"][g].dtype,
                vs["cross"][g].init) == ((20,), "float32", "zeros")
    assert vs["self"]["mlp"]["wo"].scale == pytest.approx(0.02 / 200 ** 0.5)
    keep = common.group_rows(specs, 1)
    assert keep == {"vs": 1}
    first = sum(int(np.prod((keep["vs"], *s.shape[1:])))
                if p.startswith("groups/") else int(np.prod(s.shape))
                for p, s in flatten_specs(specs))
    assert first == pytest.approx(6.38e9, rel=1e-3)


def test_params_from_jax_carries_the_nested_tree(model):
    """Every leaf of the reference's tree (the doubly stacked ``self``
    leaves, the gates) bit for bit, in the port's layout."""
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
    vs = params["groups"]["vs"]
    assert vs["self"]["attn"]["wq"].shape == (2, 1, 128, 4, 32)
    assert vs["cross"]["gate_attn"].dtype == torch.float32
    assert torch.equal(vs["cross"]["gate_mlp"], torch.full((2,), GATE))


# ---------------------------------------------------------------------- #
# the block and the whole model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("layer", [0, 1])
def test_block_apply_and_decode_match_the_reference(model, layer):
    """One super-block over 16 vision tokens: its output and its ``k`` /
    ``v`` (``[1, B, S, Hkv, D]``: one self layer) and ``ck`` / ``cv``
    caches, then 3 decode steps against them."""
    jcfg, cfg, jparams, params, sh, mesh = model
    jp = jax.tree.map(lambda a: a[layer], jparams["groups"]["vs"])
    p = jax.tree.map(lambda t: t[layer], params["groups"]["vs"])
    rng = np.random.default_rng(4 + layer)
    jx, x = bf16(rng, (B, 30, cfg.d_model))
    jc, c = bf16(rng, (B, cfg.n_ctx_tokens, cfg.d_model))
    jpos, pos = positions(B, 30)
    with jax.set_mesh(mesh):
        want, jcache = jax.jit(lambda p, x, c: jax_block_apply(
            "vision_super", p, x, jcfg, sh, jpos, c))(jp, jx, jc)
    got, cache = block_apply("vision_super", p, x, cfg, pos, c)
    close(got, want)
    assert cache.keys() == jcache.keys() == {"k", "v", "ck", "cv"}
    assert cache["k"].shape == (1, B, 30, 2, 32)
    assert cache["ck"].shape == (B, cfg.n_ctx_tokens, 2, 32)
    for key in cache:
        close(cache[key], jcache[key])
    dec = jax.jit(lambda p, x, c, pos: jax_block_decode(
        "vision_super", p, x, jcfg, sh, c, pos))
    for i in range(3):
        jx, x = bf16(rng, (B, 1, cfg.d_model))
        with jax.set_mesh(mesh):
            want, jcache = dec(jp, jx, jcache, jnp.int32(30 + i))
        got = block_decode("vision_super", p, x, cfg, cache, 30 + i)
        close(got, want)
    for key in cache:
        close(cache[key], jcache[key])


def test_prefill_and_decode_match_the_reference(model, jax_run):
    """Prefill of 2 prompts of 24 tokens over 16 vision tokens, then 4
    teacher-forced decode steps: the logits at every position and every
    cache leaf after the prefill and at the end (each step's self-layer
    write clamped to the prompt's last slot; the context caches
    unchanged)."""
    jcfg, cfg, jparams, params, sh, mesh = model
    toks, ctx, feed, want, steps, first, last, _ = jax_run
    logits, cache = prefill(params, torch.from_numpy(toks), cfg, _ctx(ctx))
    assert logits.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)

    def held(got, want):
        assert got.keys() == want.keys() == {"vs"}
        assert got["vs"].keys() == want["vs"].keys() == \
            {"k", "v", "ck", "cv"}
        for key, w in want["vs"].items():
            close(got["vs"][key], w)
    held(cache_to_numpy(cache), first)
    assert cache["vs"]["k"].shape == (2, 1, B, S, 2, 32)
    assert cache["vs"]["cv"].shape == (2, B, cfg.n_ctx_tokens, 2, 32)
    ck0 = cache["vs"]["ck"].clone()
    for i in range(DECODE_STEPS):
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    S + i, cfg)
        np.testing.assert_allclose(logits.float().numpy(), steps[i],
                                   rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
    held(cache_to_numpy(cache), last)
    assert torch.equal(cache["vs"]["ck"], ck0)


def test_the_gates_open_the_cross_layer(model, jax_run):
    """With its gates open the cross layer moves the logits with the
    context; with the drawn zero gates it adds exactly nothing, so the
    logits do not depend on the context at all."""
    jcfg, cfg, jparams, params, sh, mesh = model
    toks, ctx, *_ = jax_run
    t = torch.from_numpy(toks)
    other = _ctx(np.random.default_rng(9).standard_normal(ctx.shape))
    a, _ = prefill(params, t, cfg, _ctx(ctx))
    b, _ = prefill(params, t, cfg, other)
    assert not torch.equal(a, b)
    shut = jax.tree.map(lambda x: x, params)
    for g in ("gate_attn", "gate_mlp"):
        shut["groups"]["vs"]["cross"][g] = torch.zeros(2)
    a, _ = prefill(shut, t, cfg, _ctx(ctx))
    b, _ = prefill(shut, t, cfg, other)
    assert torch.equal(a, b)


def test_generate_with_a_context_matches_the_reference(model, jax_run):
    toks, ctx, *_, steps_fn = jax_run
    generate_matches(model, toks, ctx, 5, steps_fn)


def test_a_missing_or_stray_context_raises(model):
    """A model with context tokens never runs on no context (nor on zeros
    in its place); one without takes none; the context is ``[B, Sc, d]``
    bf16."""
    jcfg, cfg, jparams, params, sh, mesh = model
    toks = torch.zeros((B, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="ctx"):
        prefill(params, toks, cfg)
    with pytest.raises(ValueError, match="ctx"):
        ServeSession(cfg, params=params, device="cpu").generate(
            toks.numpy(), 2)
    ctx = torch.zeros((B, 16, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[B=2"):
        prefill(params, toks, cfg, ctx[:1])
    with pytest.raises(TypeError, match="bfloat16"):
        prefill(params, toks, cfg, ctx.float())
    dense = reduced(get_config("qwen3-1.7b"))
    dparams = common.init_params(build_specs(dense), 0, "cpu")
    with pytest.raises(ValueError, match="takes no context"):
        prefill(dparams, toks, dense, ctx)
