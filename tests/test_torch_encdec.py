"""The port's encoder-decoder (``enc`` / ``dec``) against the
reference's, on the CPU.

``reduced(seamless-m4t-medium)``: 2 encoder and 4 decoder layers, width
128, 4 query heads on 2 KV heads of 32, ReLU ``d_ff`` 256, vocab 512, 16
audio frames a request.  Parameters come from the reference's
``init_params`` through ``convert.params_from_jax``; the reference runs
under ``make_test_mesh()`` and its ``Sharder``.  Checked: the specs leaf
for leaf (``enc_final_norm`` included, and the output projections'
scale over the encoder's layers too: ``total_layers``) at full width and
reduced, and the full-width parameter count; ``params_from_jax``; the
encoder pass (not causal, RoPE over the frames, ``enc_final_norm``);
``block_apply`` of an ``enc`` layer (no cache) and of a ``dec`` layer
with its ``k`` / ``v`` / ``ck`` / ``cv`` caches and 3 ``block_decode``
steps; the whole model's prefill, every cache leaf and 4 decode steps
(the encoder runs once, in the prefill); ``ServeSession.generate`` over
a context; and the refusal of a missing context.

Tolerances: those of ``tests/test_torch_vision.py``, with its reasons.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import _encode as jax_encode
from repro.models.model import block_apply as jax_block_apply
from repro.models.model import block_decode as jax_block_decode
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_to_numpy
from repro_torch.models import model as port_model
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import (block_apply, block_decode, build_specs,
                                      decode_step, plan, prefill)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_vision import (LOGIT_TOL, bf16, close,  # noqa: E402
                               generate_matches, jax_steps_of, positions,
                               reference_model, specs_equal)

ARCH = "seamless-m4t-medium"
DECODE_STEPS = 4
B, S = 2, 24


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
    return reference_model(ARCH, 2)


@pytest.fixture(scope="module")
def jax_run(model):
    """The reference's prefill of 2 prompts of 24 tokens over 16 audio
    frames and its 4 teacher-forced decode steps."""
    jcfg, cfg, jparams, params, sh, mesh = model
    rng = np.random.default_rng(6)
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


@pytest.mark.parametrize("cut", [False, True])
def test_specs_equal_the_reference_leaf_for_leaf(cut):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if cut:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    specs_equal(jcfg, cfg)


def test_full_width_plan_and_count():
    """12 ``enc`` then 12 ``dec`` layers, 877,197,312 parameters as the
    reference counts them; ``total_layers`` counts the encoder's 12, so
    every output projection's scale is ``0.02 / sqrt(48)``."""
    cfg = get_config(ARCH)
    assert [(g.kind, g.n, g.name) for g in plan(cfg)] == \
        [("enc", 12, "enc"), ("dec", 12, "dec")]
    assert cfg.total_layers == 24
    assert cfg.param_count() == jax_get_config(ARCH).param_count() == \
        877_197_312
    specs = build_specs(cfg)
    assert specs["enc_final_norm"].shape == (1024,)
    dec = specs["groups"]["dec"]
    assert set(dec) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert set(specs["groups"]["enc"]) == {"ln1", "attn", "ln2", "mlp"}
    for leaf in (dec["mlp"]["wo"], dec["attn"]["wo"], dec["xattn"]["wo"]):
        assert leaf.scale == pytest.approx(0.02 / 48 ** 0.5)


def test_params_from_jax_carries_the_tree(model):
    jcfg, cfg, jparams, params, sh, mesh = model
    want = jax.tree.flatten_with_path(jax.device_get(jparams))[0]
    got = dict(flatten_specs(params))
    assert len(got) == len(want) and "enc_final_norm" in got
    for kp, w in want:
        t = got["/".join(k.key for k in kp)]
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(w).astype(np.float32))


def test_encoder_matches_the_reference(model):
    """The encoder over 40 frames: its layers not causal (the last frame
    changes the first's output), RoPE over the frames' positions, then
    ``enc_final_norm``."""
    jcfg, cfg, jparams, params, sh, mesh = model
    jc, c = bf16(np.random.default_rng(8), (B, 40, cfg.d_model))
    with jax.set_mesh(mesh):
        want = jax.jit(lambda p, c: jax_encode(p, jcfg, sh, c))(jparams, jc)
    got = port_model._encode(params, c, cfg)
    close(got, want)
    moved = c.clone()
    moved[:, -1] += 1
    assert not torch.equal(port_model._encode(params, moved, cfg)[:, 0],
                           got[:, 0])


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_apply_and_decode_match_the_reference(model, kind):
    """One layer of each kind: an ``enc`` layer's output and its empty
    cache; a ``dec`` layer's output over a 16-frame memory, its ``k`` /
    ``v`` / ``ck`` / ``cv`` caches, then 3 decode steps against them."""
    jcfg, cfg, jparams, params, sh, mesh = model
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][kind])
    p = jax.tree.map(lambda t: t[1], params["groups"][kind])
    rng = np.random.default_rng(3)
    jx, x = bf16(rng, (B, 30, cfg.d_model))
    jc, c = bf16(rng, (B, cfg.n_ctx_tokens, cfg.d_model))
    jpos, pos = positions(B, 30)
    with jax.set_mesh(mesh):
        want, jcache = jax.jit(lambda p, x, c: jax_block_apply(
            kind, p, x, jcfg, sh, jpos, c))(jp, jx, jc)
    got, cache = block_apply(kind, p, x, cfg, pos, c)
    close(got, want)
    assert cache.keys() == jcache.keys()
    if kind == "enc":
        assert cache == {}
        return
    assert cache.keys() == {"k", "v", "ck", "cv"}
    for key in cache:
        close(cache[key], jcache[key])
    dec = jax.jit(lambda p, x, c, pos: jax_block_decode(
        kind, p, x, jcfg, sh, c, pos))
    for i in range(3):
        jx, x = bf16(rng, (B, 1, cfg.d_model))
        with jax.set_mesh(mesh):
            want, jcache = dec(jp, jx, jcache, jnp.int32(30 + i))
        got = block_decode(kind, p, x, cfg, cache, 30 + i)
        close(got, want)
    for key in cache:
        close(cache[key], jcache[key])


def test_prefill_and_decode_match_the_reference(model, jax_run):
    """Prefill of 2 prompts of 24 tokens over 16 audio frames (the
    encoder, then the decoder), then 4 teacher-forced decode steps that
    skip the encoder: logits at every position and every cache leaf (the
    decoder's only) after the prefill and at the end."""
    jcfg, cfg, jparams, params, sh, mesh = model
    toks, ctx, feed, want, steps, first, last, _ = jax_run
    logits, cache = prefill(params, torch.from_numpy(toks), cfg, _ctx(ctx))
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)

    def held(got, want):
        assert got.keys() == want.keys() == {"dec"}
        assert got["dec"].keys() == want["dec"].keys() == \
            {"k", "v", "ck", "cv"}
        for key, w in want["dec"].items():
            close(got["dec"][key], w)
    held(cache_to_numpy(cache), first)
    assert cache["dec"]["k"].shape == (4, B, S, 2, 32)
    assert cache["dec"]["ck"].shape == (4, B, cfg.n_ctx_tokens, 2, 32)
    for i in range(DECODE_STEPS):
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    S + i, cfg)
        np.testing.assert_allclose(logits.float().numpy(), steps[i],
                                   rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
    held(cache_to_numpy(cache), last)


def test_generate_with_a_context_matches_the_reference(model, jax_run):
    toks, ctx, *_, steps_fn = jax_run
    generate_matches(model, toks, ctx, 5, steps_fn)


def test_a_missing_context_raises(model):
    jcfg, cfg, jparams, params, sh, mesh = model
    toks = torch.zeros((B, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="16 context tokens"):
        prefill(params, toks, cfg)
    with pytest.raises(ValueError, match="ctx"):
        prefill(params, toks, cfg,
                torch.zeros((B, 16, 64), dtype=torch.bfloat16))
