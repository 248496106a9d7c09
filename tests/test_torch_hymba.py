"""The port's Hymba against the reference's, at the reduced config.

``reduced(hymba-1.5b)`` (4 layers: full attention in layers 0 and 3, a
32-token window in layers 1-2; width 128, 5 query heads on 1 KV head of
16, SSM state 16) with its parameters from the reference's
``init_params``, moved through ``params_from_jax``.  Checked: the prefill
logits and every cache entry, 8 teacher-forced decode steps, the two
decode-cache behaviours of the reference that the port reproduces, and
``generate``'s tokens.

The decode cache of the reference, reproduced on purpose:

1. a full-attention layer's cache holds exactly the prompt, and decode
   writes the new key at ``pos``, which is past its end; the write is
   clamped to the last slot, so every step overwrites it;
2. a sliding layer's cache holds the last ``min(S, window)`` keys and is
   a ring indexed by ``pos % len``, all of it valid once ``pos >= len``;
   for ``S < window`` the ring is ``S`` long, and for ``S`` not a multiple
   of its length the ring's write does not evict the oldest key.

Prompts of 20 (shorter than the window), 40 (not a multiple of it) and
64 (a multiple) tokens.

Tolerances, with reasons: the port computes each bf16 projection as one
float32-accumulated product rounded once, as the reference does on a
CPU, but sums run in another order and the reference's compiler may keep
elementwise bf16 chains in float32, so single values flip by one bf16
ulp.  Logits, of magnitude below 1, agree to 2^-6 (two ulps at the
largest logit) and the caches to 2^-7 of their largest value: one bf16
ulp, also for the float32 SSM state, whose terms are products of bf16
inputs that may sit one ulp apart.  Greedy tokens may differ only
where the reference's top-1/top-2 margin is within twice the logit
tolerance, and are compared up to the first such difference.
"""
import dataclasses

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
from repro.models.model import build_specs as jax_build_specs
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import prefill as jax_prefill
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_to_numpy, params_from_jax
from repro_torch.launch.serve import ServeSession
from repro_torch.models import model as port_model
from repro_torch.models.common import (init_params, init_params_np,
                                       params_to_torch)
from repro_torch.models.model import build_specs, decode_step, plan, prefill

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
    jcfg = jax_reduced(jax_get_config("hymba-1.5b"))
    cfg = reduced(get_config("hymba-1.5b"))
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
    assert got.keys() == want.keys()
    for g in want:
        assert got[g].keys() == want[g].keys()
        for k, w in want[g].items():
            assert got[g][k].shape == w.shape, (g, k)
            np.testing.assert_allclose(got[g][k], w, rtol=0,
                                       atol=CACHE_TOL * np.abs(w).max(),
                                       err_msg=f"{g}/{k}")


def test_params_from_jax_keeps_every_bit(models):
    _, cfg, jparams, params, _, _ = models
    want = jax.tree.leaves(jax.device_get(jparams))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    bad = jax.device_get(jparams)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(bad, cfg, "cpu")


def test_numpy_weights_feed_both_packages(models, jax_steps):
    """The golden's path at small size: the seeded numpy weights, rounded
    to bf16 by each framework, are the same bits on both sides, and the
    two models agree on them."""
    _, cfg, _, _, _, mesh = models
    specs = build_specs(cfg)
    arrays = init_params_np(specs, 7)
    params = params_to_torch(specs, arrays, "cpu")
    same = init_params(specs, 7, "cpu")
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                           arrays, specs,
                           is_leaf=lambda x: isinstance(x, np.ndarray))
    moved = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    for a, b, c in zip(jax.tree.leaves(params), jax.tree.leaves(same),
                       jax.tree.leaves(moved)):
        assert torch.equal(a, b) and torch.equal(a, c)
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
    _check_logits(logits, want_logits)
    _check_cache(cache, want_cache)


@pytest.mark.parametrize("S", [20, 40])
def test_teacher_forced_decode(models, jax_steps, S):
    """8 decode steps on the same tokens; logits at every step and the
    whole cache at the end."""
    _, cfg, jparams, params, _, mesh = models
    toks = _prompt(S, cfg.vocab)
    feed = np.random.default_rng(S).integers(0, cfg.vocab,
                                             (DECODE_STEPS, 2, 1),
                                             dtype=np.int32)
    with jax.set_mesh(mesh):
        _, want_cache = jax_steps[0](jparams, jnp.asarray(toks))
    _, cache = prefill(params, torch.from_numpy(toks), cfg)
    for i in range(DECODE_STEPS):
        with jax.set_mesh(mesh):
            want_logits, want_cache = jax_steps[1](
                jparams, want_cache, jnp.asarray(feed[i]), jnp.int32(S + i))
        logits, cache = decode_step(params, cache, torch.from_numpy(feed[i]),
                                    S + i, cfg)
        _check_logits(logits, want_logits)
    _check_cache(cache, want_cache)


def test_decode_cache_reproduces_the_reference(models):
    """The two cache behaviours of the module docstring, on the port."""
    _, cfg, _, params, _, _ = models
    W = cfg.sliding_window
    groups = {g.name: g for g in plan(cfg)}
    for S in (20, 40):
        toks = torch.from_numpy(_prompt(S, cfg.vocab))
        _, cache = prefill(params, toks, cfg)
        before = {g: {k: t.clone() for k, t in c.items()}
                  for g, c in cache.items()}
        for g, c in cache.items():
            full = groups[g].kind == "hybrid_full"
            assert c["k"].shape[2] == (S if full else min(S, W))
        for i in range(2):
            _, cache = decode_step(params, cache,
                                   toks[:, i:i + 1], S + i, cfg)
        for g, c in cache.items():
            n = c["k"].shape[2]
            changed = (c["k"] != before[g]["k"]).any(-1).any(-1).any(1)
            slots = sorted(set(torch.nonzero(changed)[:, 1].tolist()))
            if groups[g].kind == "hybrid_full":
                assert slots == [S - 1], g             # clamped write
            else:
                assert slots == sorted({S % n, (S + 1) % n}), g    # ring


def test_generate_matches_the_reference(models, jax_steps):
    """Greedy tokens of both ServeSessions, up to the first difference,
    which may only come at a near tie of the reference."""
    jcfg, cfg, jparams, params, sh, mesh = models
    toks = _prompt(40, cfg.vocab, seed=5)
    max_new = 6
    with jax.set_mesh(mesh):
        want = JaxServeSession(jcfg, sh, params=jparams).generate(toks,
                                                                  max_new)
        # the reference's margins on its own greedy path
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
                # only a near tie may flip, and the paths part there
                assert margins[i][row] <= 2 * LOGIT_TOL, (row, i)
                break


def test_serve_session_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = models[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(cfg)


def test_every_reference_arch_is_registered_and_an_unknown_one_raises():
    """The port registers every arch of the reference's registry (the
    vision super-block and the encoder-decoder included), and an unknown
    arch raises ``KeyError``."""
    from repro.configs import REGISTRY as JAX_REGISTRY
    from repro_torch.configs import REGISTRY
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-medium"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_dense_and_moe_archs_are_ported():
    """The archs that used to raise build, with the reference's plan and
    parameter count at full width."""
    from repro.models.model import plan as jax_plan
    for arch in ("qwen3-1.7b", "qwen3-moe-235b-a22b", "nemotron-4-15b",
                 "starcoder2-15b", "command-r-plus-104b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert [dataclasses.astuple(g) for g in plan(cfg)] == \
            [(g.kind, g.n, g.name) for g in jax_plan(jcfg)]
        assert cfg.param_count() == jcfg.param_count()
    cfg = reduced(get_config("hymba-1.5b"))
    assert set(port_model.block_specs(cfg, "dense")) == \
        {"ln1", "attn", "ln2", "mlp"}


@pytest.mark.gpu
def test_prefill_launches_both_kernels_once_per_layer(models):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.selective_scan import kernel as ss
    _, cfg, _, params, _, _ = models
    params = jax.tree.map(lambda t: t.cuda(), params)
    toks = torch.from_numpy(_prompt(64, cfg.vocab)).cuda()
    fa.reset_launch_counts()
    ss.reset_launch_counts()
    _, cache = prefill(params, toks, cfg)
    assert fa.launch_counts()["flash_attention"] == cfg.n_layers
    assert ss.launch_counts()["selective_scan"] == cfg.n_layers
    decode_step(params, cache, toks[:, :1], 64, cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_attention"] == cfg.n_layers
    assert ss.launch_counts()["selective_scan"] == cfg.n_layers
