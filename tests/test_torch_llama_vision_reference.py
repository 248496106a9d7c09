"""The JAX reference's greedy run of ``llama-3.2-vision-90b``'s first
super-block at full width.

One golden, ``tests/golden/torch_llama_3_2_vision_90b_sb1_s1024.json``:
one request served by the reference package on the CPU, with weights
from the port's numpy synthesis (``repro_torch.models.common``, seed 0)
rounded to each leaf's dtype, one prompt of 1,024 tokens drawn with
``np.random.default_rng(0)``, a context of 1,600 vision tokens (the stub
frontend's patch embeddings: ``context``, standard normals from
``np.random.default_rng(1)`` rounded to bf16), the prefill, then 16
greedy decode steps, with the greedy token, the top-8 ``(token,
logit)``, the top-1/top-2 margin and the ``logsumexp`` at each (as
``tests/test_torch_qwen3_reference.py`` records them).

The model is Llama-3.2-Vision-90B at full width (d 8,192, 64 query heads
on 8 KV heads of 128, ``d_ff`` 28,672 SwiGLU, vocab 128,256, RoPE θ
5e5) cut in depth only, to its first super-block of 20: 4 self layers
and 1 gated cross layer, 5 of 100 layers, each stacked leaf's first row
(``group_rows``: a row of the ``vs`` group is a super-block) drawn at the
100-layer model's scales; 6.38 B parameters of 87.7 B.

The synthesis draws the cross layer's two gates as zeros, as the
reference's init does, and ``tanh(0) = 0`` would make the cross layer
add nothing to the residual: a golden with zero gates passes whatever
the cross-attention computes.  So both packages set ``gate_attn =
gate_mlp = GATE = 1.0`` (``set_gates``) before the run, and the file
records the value.

``chip_smoke.py`` phase 26 holds the port on the card to the golden by
phase 10's rule (top-8 within 4 bf16 ulps of the golden's largest top
logit, the top-1 where the margin exceeds twice that, the logsumexp
within 2^-8).  ``--port-cpu`` runs the port on the CPU against the
golden and prints its errors.

The tests here do not run the model: they check the file's format, the
digests of the leaves and of the context, the gates, the prompt, and
that ``chip_smoke.py`` uses this file, its gates and these tolerances.

Regenerate with ``PYTHONPATH=src python
tests/test_torch_llama_vision_reference.py --capture`` (in the
background, alone; it prints its peak RSS).
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_qwen3_reference import (CTX_SEED, DECODE_STEPS,  # noqa: E402
                                        LSE_TOL, PROMPT_LEN, PROMPT_SEED,
                                        SEED, TOPK, capture_golden, context,
                                        digest, leaf_digests, logit_tol,
                                        port_against, prompt)

ARCH = "llama-3.2-vision-90b"
GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_llama_3_2_vision_90b_sb1_s1024.json"
LAYERS = 5                   # the first super-block: 4 self + 1 cross
SUPER_BLOCKS = 1             # rows of the `vs` group kept
CTX_LEN = 1600               # vision tokens
GATE = 1.0                   # gate_attn and gate_mlp of the golden's run


def set_gates(params: dict, full):
    """``params`` (either package's tree) with the cross layers' gates
    set to ``GATE``: a new tree, the rest shared."""
    cross = params["groups"]["vs"]["cross"]
    gates = {k: full(cross[k], GATE) for k in ("gate_attn", "gate_mlp")}
    return {**params, "groups": {**params["groups"], "vs": {
        **params["groups"]["vs"], "cross": {**cross, **gates}}}}


def _jax_gates(params):
    import jax.numpy as jnp
    return set_gates(params, jnp.full_like)


def _torch_gates(params):
    import torch
    return set_gates(params, torch.full_like)


def capture() -> None:
    """Run the reference on the first super-block and write the golden."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.common import group_rows
    from repro_torch.models.model import build_specs
    cfg = get_config(ARCH)
    specs = build_specs(cfg)
    ctx = context(CTX_LEN, cfg.d_model)
    cut = {"layers": f"the first {LAYERS} of 100 (super-block 1 of 20)",
           "group_layers": group_rows(specs, SUPER_BLOCKS),
           "scales": "the 100-layer model's"}
    capture_golden(GOLDEN, dataclasses.replace(jax_get_config(ARCH),
                                               n_layers=LAYERS),
                   specs, LAYERS,
                   {"arch": ARCH, "cut": cut, "gates": GATE,
                    "ctx_seed": CTX_SEED, "ctx_len": CTX_LEN,
                    "ctx_sha256": digest(ctx)},
                   group_cut=SUPER_BLOCKS, ctx=ctx, edit=_jax_gates)


def port_cpu() -> None:
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    port_against(json.loads(GOLDEN.read_text()), cfg, LAYERS,
                 group_cut=SUPER_BLOCKS, ctx=context(CTX_LEN, cfg.d_model),
                 edit=_torch_gates)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["layers"], golden["seed"],
            golden["prompt_seed"], golden["prompt_len"],
            golden["decode_steps"], golden["topk"], golden["ctx_seed"],
            golden["ctx_len"], golden["gates"]) == \
        (ARCH, LAYERS, SEED, PROMPT_SEED, PROMPT_LEN, DECODE_STEPS, TOPK,
         CTX_SEED, CTX_LEN, GATE)
    assert golden["cut"]["group_layers"] == {"vs": SUPER_BLOCKS}
    steps = golden["steps"]
    assert len(steps) == DECODE_STEPS + 1
    assert golden["tokens"] == [s["top"][0][0] for s in steps]
    for s in steps:
        toks = [t for t, _ in s["top"]]
        vals = [v for _, v in s["top"]]
        assert len(toks) == TOPK and len(set(toks)) == TOPK
        assert all(0 <= t < golden["vocab"] for t in toks)
        assert vals == sorted(vals, reverse=True)
        assert s["margin"] == vals[0] - vals[1] >= 0
        assert np.isfinite(s["lse"]) and s["lse"] >= vals[0]


def test_numpy_weights_and_context_reproduce_the_golden(golden):
    """The port's numpy synthesis gives the capture's float32 weights (the
    first values of every leaf of the 100-layer specs and every small leaf
    whole) and its context; the gates are drawn as zeros, which is why
    the run sets them."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    cfg = get_config(ARCH)
    leaves = flatten_specs(build_specs(cfg))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == golden["leaf_sha256"]
    specs = dict(leaves)
    for g in ("gate_attn", "gate_mlp"):
        spec = specs[f"groups/vs/cross/{g}"]
        assert (tuple(spec.shape), spec.dtype, spec.init) == \
            ((20,), "float32", "zeros")
    assert digest(context(CTX_LEN, cfg.d_model)) == golden["ctx_sha256"]


def test_set_gates_sets_only_the_gates():
    """``set_gates`` on the port's reduced tree: both gates of every
    super-block are ``GATE``, every other leaf is the same tensor."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import flatten_specs, init_params
    from repro_torch.models.model import build_specs
    params = init_params(build_specs(reduced(get_config(ARCH))), SEED, "cpu")
    gated = _torch_gates(params)
    for (path, a), (_, b) in zip(flatten_specs(params),
                                 flatten_specs(gated)):
        if path.endswith(("gate_attn", "gate_mlp")):
            assert torch.equal(a, torch.zeros(2))
            assert torch.equal(b, torch.full((2,), GATE))
        else:
            assert b is a, path


def test_prompt_draws_again(golden):
    toks = prompt(golden["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < golden["vocab"]


def test_chip_smoke_holds_the_card_to_this_golden(golden):
    """``chip_smoke.py`` phase 26 reads this file, runs its cut with these
    gates and derives the tolerance by this file's rule."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    run = cs.CROSS_MODELS[ARCH]
    assert run["golden"].name == GOLDEN.name
    assert (run["layers"], run["group_cut"], run["ctx"], run["gates"]) == \
        (LAYERS, SUPER_BLOCKS, CTX_LEN, GATE)
    assert cs.logit_tol(golden) == logit_tol(golden) and \
        cs.LSE_TOL == LSE_TOL
    assert cs.CTX_SEED == CTX_SEED


if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["--capture"]:
        capture()
    elif args == ["--port-cpu"]:
        port_cpu()
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture | --port-cpu")
