"""The JAX reference's greedy run of ``deepseek-v3-671b`` at full width.

One golden, ``tests/golden/torch_deepseek_v3_671b_l4_e64_s1024.json``:
one request served by the reference package on the CPU, with weights
from the port's numpy synthesis (``repro_torch.models.common``, seed 0)
rounded to each leaf's dtype, one prompt of 1,024 tokens drawn with
``np.random.default_rng(0)``, the prefill, then 16 greedy decode steps,
with the greedy token, the top-8 ``(token, logit)``, the top-1/top-2
margin and the ``logsumexp`` at each (as
``tests/test_torch_qwen3_reference.py`` records them).

The model is DeepSeek-V3 at full width (d 7,168, 128 heads, MLA with
``q_lora`` 1,536, ``kv_lora`` 512, ``nope_dim`` 128, ``rope_dim`` 64,
``v_dim`` 128; ``dense_d_ff`` 18,432; top 8 of routed experts of
``d_expert`` 2,048, one shared expert, the router bias; vocab 129,280),
cut twice:

* in depth, to its first 4 of 61 layers (3 ``mla_dense``, 1
  ``mla_moe``), drawn at the 61-layer model's scales: all 61 layers are
  about 1.3 TB in bf16;
* in routed experts, to 64 of 256 (``N_EXPERTS``): one 256-expert layer
  holds 11.5 B parameters, and XLA's CPU einsum over a bf16 ``wi`` takes
  about 3.5 times the weight's bytes at its peak (an float32 copy and
  more), which a 62 GB host cannot hold.  Every matrix keeps its full
  width; the capacity at 1,024 tokens is ``max(4, 1024 * 8 * 1.25 /
  64)`` = 160.

The golden's weights are the full model's draw but for the router: the
64 experts' ``wi`` and ``wo`` are the first 64 of the 256-expert
leaves' layer 0 (a C-order prefix of each leaf's one stream), while the
``[d, 64]`` router is the first ``d * 64`` values of the router's stream,
not the first columns of ``[d, 256]``.  So ``chip_smoke.py`` phase 24
builds the golden's model from the 256-expert draw and draws the small
router again (``golden_router``).  The file records the cut and a
SHA-256 of each leaf's first 4,096 float32 values (and of every small
leaf whole) of the golden's 64-expert specs.

``chip_smoke.py`` phase 24 holds the port on the card to the golden by
phase 10's rule (top-8 within 4 bf16 ulps of the golden's largest top
logit, the top-1 where the margin exceeds twice that, the logsumexp
within 2^-8) and the MoE's flip rule of
``tests/test_torch_qwen3_reference.py`` (a position beyond it counts as
a routing flip if its top-8 are within 1.0 and its logsumexp within
2^-8; at most a quarter of the positions).  ``--port-cpu`` runs the port
on the CPU against the golden and prints its errors.

The tests here do not run the model: they check the file's format, the
digests, the expert prefix, the prompt, and that ``chip_smoke.py`` uses
this file and these tolerances.

Regenerate with ``PYTHONPATH=src python
tests/test_torch_deepseek_reference.py --capture`` (in the background,
alone; it prints its peak RSS).
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_qwen3_reference import (DECODE_STEPS, LSE_TOL,  # noqa: E402
                                        MOE_FLIP_SHARE, MOE_FLIP_TOL,
                                        PROMPT_LEN, PROMPT_SEED, SEED, TOPK,
                                        capture_golden, leaf_digests,
                                        logit_tol, port_against, prompt)

ARCH = "deepseek-v3-671b"
GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_deepseek_v3_671b_l4_e64_s1024.json"
LAYERS = 4                   # the golden's first layers of 61
N_EXPERTS = 64               # the golden's routed experts of 256


def golden_config(cfg):
    """``cfg`` (either package's full DeepSeek config) with the golden's
    64 routed experts, at the whole model's depth: the specs whose
    scales and leaf streams the golden's weights are drawn from."""
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_experts=N_EXPERTS))


def capture() -> None:
    """Run the reference on the golden's cut and write the golden."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.common import group_rows
    from repro_torch.models.model import build_specs
    specs = build_specs(golden_config(get_config(ARCH)))
    cut = {"layers": f"the first {LAYERS} of 61",
           "group_layers": group_rows(specs, LAYERS),
           "routed_experts": f"{N_EXPERTS} of 256",
           "scales": "the 61-layer model's"}
    capture_golden(GOLDEN, dataclasses.replace(
        golden_config(jax_get_config(ARCH)), n_layers=LAYERS), specs, LAYERS,
        {"arch": ARCH, "n_experts": N_EXPERTS, "cut": cut})


def port_cpu() -> None:
    from repro_torch.configs import get_config
    port_against(json.loads(GOLDEN.read_text()),
                 golden_config(get_config(ARCH)), LAYERS)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["layers"], golden["n_experts"],
            golden["seed"], golden["prompt_seed"], golden["prompt_len"],
            golden["decode_steps"], golden["topk"]) == \
        (ARCH, LAYERS, N_EXPERTS, SEED, PROMPT_SEED, PROMPT_LEN,
         DECODE_STEPS, TOPK)
    assert golden["cut"]["group_layers"] == {"d": 3, "e": 1}
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


def test_numpy_weights_reproduce_the_golden(golden):
    """The port's numpy synthesis gives the capture's float32 weights: the
    first values of every leaf of the golden's 64-expert specs and every
    small leaf whole."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    leaves = flatten_specs(build_specs(golden_config(get_config(ARCH))))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == golden["leaf_sha256"]


def test_golden_experts_are_a_prefix_of_the_full_draw(golden):
    """The golden's leaves are the 256-expert model's, leaf index for leaf
    index: every leaf's stream begins with the same values (the digests'
    heads), so ``wi`` and ``wo``, C-order prefixes, are the first experts
    of the full leaves, while the router's ``[d, 64]`` rows cut the same
    stream otherwise than ``[d, 256]``.  At reduced size, whole: the
    first 4 of 8 experts of the first ``mla_moe`` layer equal a 4-expert
    draw's, and the routers differ."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import (flatten_specs, init_params,
                                           leaf_blocks_np)
    from repro_torch.models.model import build_specs
    full = flatten_specs(build_specs(get_config(ARCH)))
    cut = flatten_specs(build_specs(golden_config(get_config(ARCH))))
    assert [p for p, _ in full] == [p for p, _ in cut]
    for i, ((path, a), (_, b)) in enumerate(zip(full, cut)):
        if a.init in ("zeros", "ones"):     # no stream: the bias, norms
            assert b.init == a.init, path
            continue
        assert leaf_digests(a, i)["head"] == \
            golden["leaf_sha256"][path]["head"], path
        if "/moe/" in path and tuple(a.shape) != tuple(b.shape):
            assert a.shape[-1] == 256 or a.shape[1] == 256, path
    assert tuple(dict(cut)["groups/e/moe/router"].shape) == \
        (58, 7168, N_EXPERTS)
    cfg = reduced(get_config(ARCH))
    half = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=4))
    whole = init_params(build_specs(cfg), SEED, "cpu", layers=2)
    part = init_params(build_specs(half), SEED, "cpu", layers=2)
    w, p = whole["groups"]["e"]["moe"], part["groups"]["e"]["moe"]
    assert w["wi"].shape[:2] == (1, 8) and p["wi"].shape[:2] == (1, 4)
    for key in ("wi", "wo", "router_bias"):
        assert torch.equal(w[key][:, :4], p[key]), key
    assert not torch.equal(w["router"][..., :4], p["router"])
    # the router the card draws again is the 4-expert draw's
    paths = [p for p, _ in flatten_specs(build_specs(half))]
    i = paths.index("groups/e/moe/router")
    spec = flatten_specs(build_specs(half))[i][1]
    drawn = np.concatenate([b for _, _, b in leaf_blocks_np(spec, SEED, i,
                                                            rows=1)])
    np.testing.assert_array_equal(drawn.reshape(p["router"].shape),
                                  p["router"].numpy())


def test_prompt_draws_again(golden):
    toks = prompt(golden["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < golden["vocab"]


def test_chip_smoke_holds_the_card_to_this_golden(golden):
    """``chip_smoke.py`` phase 24 reads this file, runs its cut and
    derives the tolerance by this file's rule."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.DEEPSEEK["golden"].name == GOLDEN.name
    assert (cs.DEEPSEEK["layers"], cs.DEEPSEEK["golden_experts"]) == \
        (LAYERS, N_EXPERTS)
    assert cs.logit_tol(golden) == logit_tol(golden) and \
        cs.LSE_TOL == LSE_TOL
    assert (cs.MOE_FLIP_TOL, cs.MOE_FLIP_SHARE) == (MOE_FLIP_TOL,
                                                    MOE_FLIP_SHARE)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["--capture"]:
        capture()
    elif args == ["--port-cpu"]:
        port_cpu()
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture | --port-cpu")
