"""The JAX reference's greedy run of ``seamless-m4t-medium``, whole.

One golden, ``tests/golden/torch_seamless_m4t_medium_s1024.json``: one
request served by the reference package on the CPU, with weights from
the port's numpy synthesis (``repro_torch.models.common``, seed 0)
rounded to each leaf's dtype, one prompt of 1,024 tokens drawn with
``np.random.default_rng(0)``, a context of 1,024 audio frames (the stub
frontend's embeddings: ``context``, standard normals from
``np.random.default_rng(1)`` rounded to bf16), the prefill, then 16
greedy decode steps, with the greedy token, the top-8 ``(token,
logit)``, the top-1/top-2 margin and the ``logsumexp`` at each (as
``tests/test_torch_qwen3_reference.py`` records them).

The model is not cut: 12 encoder and 12 decoder layers, d 1,024, 16
heads of 64 (group 1), ``d_ff`` 4,096 ReLU, vocab 256,206; 0.88 B
parameters.  Every attention of its prefill is the flash-attention op:
the encoder's not causal over the frames, the decoder's causal, its
cross layers not causal over the encoder's output.

``chip_smoke.py`` phase 25 holds the port on the card to the golden by
phase 10's rule (top-8 within 4 bf16 ulps of the golden's largest top
logit, the top-1 where the margin exceeds twice that, the logsumexp
within 2^-8).  ``--port-cpu`` runs the port on the CPU against the
golden and prints its errors.

The tests here do not run the model: they check the file's format, the
digests of the leaves and of the context, the prompt, and that
``chip_smoke.py`` uses this file and these tolerances.

Regenerate with ``PYTHONPATH=src python
tests/test_torch_seamless_reference.py --capture`` (in the background,
alone; it prints its peak RSS).
"""
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

ARCH = "seamless-m4t-medium"
GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_seamless_m4t_medium_s1024.json"
LAYERS = 12                  # decoder layers (and 12 encoder layers)
CTX_LEN = 1024               # audio frames


def capture() -> None:
    """Run the reference on the whole model and write the golden."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_specs
    cfg = get_config(ARCH)
    ctx = context(CTX_LEN, cfg.d_model)
    capture_golden(GOLDEN, jax_get_config(ARCH), build_specs(cfg), LAYERS,
                   {"arch": ARCH, "enc_layers": cfg.enc_layers,
                    "ctx_seed": CTX_SEED, "ctx_len": CTX_LEN,
                    "ctx_sha256": digest(ctx)},
                   group_cut=cfg.total_layers, ctx=ctx)


def port_cpu() -> None:
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    port_against(json.loads(GOLDEN.read_text()), cfg, LAYERS,
                 group_cut=cfg.total_layers,
                 ctx=context(CTX_LEN, cfg.d_model))


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["layers"], golden["enc_layers"],
            golden["seed"], golden["prompt_seed"], golden["prompt_len"],
            golden["decode_steps"], golden["topk"], golden["ctx_seed"],
            golden["ctx_len"]) == \
        (ARCH, LAYERS, 12, SEED, PROMPT_SEED, PROMPT_LEN, DECODE_STEPS, TOPK,
         CTX_SEED, CTX_LEN)
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
    first values of every leaf and every small leaf whole; the
    ``enc_final_norm`` among them) and its context."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    cfg = get_config(ARCH)
    leaves = flatten_specs(build_specs(cfg))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == golden["leaf_sha256"]
    assert "enc_final_norm" in got
    assert digest(context(CTX_LEN, cfg.d_model)) == golden["ctx_sha256"]


def test_prompt_draws_again(golden):
    toks = prompt(golden["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < golden["vocab"]


def test_chip_smoke_holds_the_card_to_this_golden(golden):
    """``chip_smoke.py`` phase 25 reads this file, runs the whole model
    over its context and derives the tolerance by this file's rule."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    run = cs.CROSS_MODELS[ARCH]
    assert run["golden"].name == GOLDEN.name
    assert (run["layers"], run["group_cut"], run["ctx"]) == \
        (LAYERS, None, CTX_LEN)
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
