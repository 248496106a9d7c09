"""The port's training path against the reference's, on the CPU.

At the reference's ``reduced`` size (4 layers, width 128, vocab 512), one
arch of each block kind — ``qwen3-1.7b`` (``dense``),
``qwen3-moe-235b-a22b`` (``moe``), ``deepseek-v3-671b`` (``mla_dense``,
``mla_moe``), ``hymba-1.5b`` (``hybrid``, ``hybrid_full``),
``falcon-mamba-7b`` (``mamba``), ``llama-3.2-vision-90b``
(``vision_super``) and ``seamless-m4t-medium`` (``enc``, ``dec``) — the
port's ``loss_fn`` and the gradient of every parameter leaf
(``launch.steps.grads_and_loss``, autograd through the plain kernel
versions and ``FlashAttentionFn``'s backward) are held against the
reference's ``jax.value_and_grad(loss_fn)`` on the same weights (the
port's numpy synthesis, rounded to each leaf's dtype by each package)
and the same batch (``SyntheticLM``, B = 2, S = 32; a model with context
tokens gets a seeded bf16 context; the vision model's gates set to 1.0
in both, as its serving tests set them: drawn as zeros they hide the
cross layers, whose weights then get no gradient).

Tolerances, with reasons: the loss to ``LOSS_TOL`` = 2^-10 (measured at
most 1.2e-4, DeepSeek); each leaf's gradient to ``GRAD_RTOL`` = 2^-5 in
relative L2 norm (measured at most 0.0181, Hymba's full-attention
``wk``: bf16 products and sums in other orders, one-ulp flips in every
layer).  Two
kinds of leaves are held looser, each for a stated reason:

* a ReLU model's MLP input (``mlp/wi``, ``ln2``) to ``KINK_RTOL`` = 2^-3
  (measured 0.049, seamless): a pre-activation within an ulp of 0 takes
  the other side of the kink in one package, and its whole term drops
  out of the other's sum (with a smooth activation the same model is
  within 0.012);
* a scalar gate (``gate_attn``, ``gate_mlp``) to ``GATE_RTOL`` = 2^-2
  (measured 0.073): its gradient is one sum over every position and
  feature, which cancels to a small fraction of its terms.

An MoE token whose top-k boundary is a near tie (the gap between its
k-th and (k+1)-th selection score below ``NEAR_TIE``, the rule of
``tests/test_torch_dense.py``; a quarter of it on DeepSeek's biased
sigmoid scores, as ``tests/test_torch_mla.py`` takes it) may take
another expert in the port than in the reference, and that expert's
gradient then gains or loses the token's whole term.  So the expert and
router leaves of a layer with a near tie are held to ``FLIP_RTOL`` = 1
(a gradient of the same size), the other layers' to ``GRAD_RTOL``, and
at most a tenth of the tokens may be near ties.  On these batches the
Qwen3 MoE has near ties in 3 of its 4 layers (7.8 % of the tokens) and
DeepSeek in 2 of its 3 MoE layers (4.7 %), and no token took another
expert: those layers' leaves are within 0.011 as well.

Also checked: the three ``remat`` modes give the same loss and
gradients bit for bit.  The training step, the optimizer state, the
fault-tolerant driver, the step builders and the abstract inputs are
held in ``tests/test_torch_train_steps.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh as jax_test_mesh
from repro.models.model import loss_fn as jax_loss_fn
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models.common import (flatten_specs, init_params_np,
                                       params_to_torch)
from repro_torch.models.model import build_specs

ARCHS = ("qwen3-1.7b", "qwen3-moe-235b-a22b", "deepseek-v3-671b",
         "hymba-1.5b", "falcon-mamba-7b", "llama-3.2-vision-90b",
         "seamless-m4t-medium")
B, S = 2, 32
LOSS_TOL = 2 ** -10
GRAD_RTOL = 2 ** -5
KINK_RTOL = 2 ** -3
GATE_RTOL = 2 ** -2
NEAR_TIE = 2 ** -9
FLIP_RTOL = 1.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(specs, arrays):
    """The numpy float32 draw as the reference's arrays of each spec's
    dtype (bf16 rounds to nearest even, as torch's cast does)."""
    if isinstance(specs, dict):
        return {k: _to_jax(specs[k], arrays[k]) for k in specs}
    return jnp.asarray(arrays).astype(jnp.dtype(specs.dtype))


def _setup(arch: str, seq: int = S):
    """(jax cfg, port cfg, jax params, port params, jax batch, port
    batch) on one draw of weights and one batch."""
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    specs = build_specs(cfg)
    arrays = init_params_np(specs, 0)
    if cfg.family == "vlm":
        cross = arrays["groups"]["vs"]["cross"]
        cross["gate_attn"] = np.ones_like(cross["gate_attn"])
        cross["gate_mlp"] = np.ones_like(cross["gate_mlp"])
    batch = SyntheticLM(DataConfig(cfg.vocab, seq, B), device="cpu") \
        .batch_np(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cfg.n_ctx_tokens:
        ctx = np.random.default_rng(1).standard_normal(
            (B, cfg.n_ctx_tokens, cfg.d_model), dtype=np.float32)
        jb["ctx"] = jnp.asarray(ctx).astype(jnp.bfloat16)
        tb["ctx"] = torch.from_numpy(ctx).to(torch.bfloat16)
    return (jcfg, cfg, _to_jax(specs, arrays),
            params_to_torch(specs, arrays, "cpu"), jb, tb)


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else \
        float(np.abs(got).max())


def _near_tie_layers(params, batch, cfg) -> tuple:
    """``{group: layer indices}`` of the MoE layers where some token's
    top-k boundary is a near tie in the port's forward (``route``'s
    selection score), and the share of tokens that have one."""
    seen = []
    route = moe.route

    def spy(p, logits, m):
        score, tie = logits, NEAR_TIE
        if "router_bias" in p:          # the sigmoid's slope is <= 1/4
            score = torch.sigmoid(logits) + p["router_bias"].float()
            tie = NEAR_TIE / 4
        top = score.sort(-1, descending=True).values
        seen.append((top[:, m.top_k - 1] - top[:, m.top_k] < tie).detach())
        return route(p, logits, m)
    moe.route = spy
    try:
        with torch.no_grad():
            steps.M.forward_train(params, batch, cfg)
    finally:
        moe.route = route
    out, tied, i = {}, torch.zeros(B * S, dtype=torch.bool), 0
    for g in steps.M.plan(cfg):
        if not g.kind.endswith("moe"):
            continue
        for layer in range(g.n):
            near = seen[i]
            tied |= near
            if near.any():
                out.setdefault(g.name, set()).add(layer)
            i += 1
    assert i == len(seen)
    return out, float(tied.float().mean())


def _tolerance(cfg, path: str) -> float:
    leaf = path.split("/")[-1]
    if leaf in ("gate_attn", "gate_mlp"):
        return GATE_RTOL
    if cfg.act == "relu" and (path.endswith("mlp/wi") or leaf == "ln2"):
        return KINK_RTOL
    return GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    jcfg, cfg, jp, params, jb, tb = _setup(arch)
    mesh = jax_test_mesh()
    sh = Sharder(mesh)
    with jax.set_mesh(mesh):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jax_loss_fn(p, b, jcfg, sh)))(jp, jb)
    jgrads = jax.device_get(jgrads)
    loss, grads = steps.grads_and_loss(params, tb, cfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    tied, share = _near_tie_layers(params, tb, cfg)
    assert share <= 0.1
    for path, spec in flatten_specs(build_specs(cfg)):
        g, w = _leaf(grads, path), np.asarray(_leaf(jgrads, path),
                                              np.float32)
        assert g.dtype == params_to_torch(spec, np.zeros(spec.shape),
                                          "cpu").dtype, path
        assert tuple(g.shape) == w.shape, path
        g = g.float().numpy()
        assert np.isfinite(g).all(), path
        parts = path.split("/")
        flips = tied.get(parts[1], set()) if parts[:1] == ["groups"] and \
            "moe" in parts else set()
        held = [i for i in range(g.shape[0]) if i not in flips]
        assert _rel(g[held], w[held]) <= _tolerance(cfg, path), path
        for i in flips:
            assert _rel(g[i], w[i]) <= FLIP_RTOL, (path, i)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b",
                                  "qwen3-moe-235b-a22b"])
def test_remat_modes_agree(arch):
    """``full``, ``dots`` and ``none`` recompute or keep the same values:
    the same loss and gradients, bit for bit."""
    _, cfg, _, params, _, tb = _setup(arch, seq=16)
    out = {}
    for mode in ("full", "dots", "none"):
        out[mode] = steps.grads_and_loss(
            params, tb, dataclasses.replace(cfg, remat=mode))
    loss, grads = out["none"]
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], loss), mode
        for path, _ in flatten_specs(build_specs(cfg)):
            assert torch.equal(_leaf(out[mode][1], path),
                               _leaf(grads, path)), (mode, path)
    with pytest.raises(ValueError, match="remat"):
        steps.grads_and_loss(params, tb,
                             dataclasses.replace(cfg, remat="some"))
