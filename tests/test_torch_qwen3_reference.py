"""The JAX reference's greedy runs of the two Qwen3 models at full width.

Two goldens, each one request served by the reference package on the
CPU, with weights from the port's numpy synthesis
(``repro_torch.models.common.leaf_blocks_np``, seed 0) rounded to each
leaf's dtype, one prompt of 1,024 tokens drawn with
``np.random.default_rng(0)``, the prefill, then 16 greedy decode steps:

* ``tests/golden/torch_qwen3_1_7b_s1024.json``: ``qwen3-1.7b``, all 28
  layers (d 2,048, 16 query heads on 8 KV heads of 128, d_ff 6,144,
  vocab 151,936, qk-norm, RoPE θ 1e6);
* ``tests/golden/torch_qwen3_moe_235b_a22b_l2_s1024.json``:
  ``qwen3-moe-235b-a22b`` at full width (d 4,096, 64 query heads on 4 KV
  heads of 128, 128 experts, top 8, ``d_expert`` 1,536) cut to its first
  2 of 94 layers: each stacked leaf's first 2 layers, drawn at the
  94-layer model's scales (the whole model is 470 GB in bf16; the first
  2 layers and the embeddings are 12.2 GB).

At the prefill and at each step a golden keeps the greedy token, the
top-8 ``(token, logit)`` over the real vocabulary (ties to the lower
index), the top-1/top-2 margin and the ``logsumexp`` in float64 of the
bf16 logits.  ``chip_smoke.py`` phases 22 and 23 hold the port on the
card to them, by phase 10's rule: the top-8 logits within 4 bf16 ulps of
the golden's largest top logit (``logit_tol``), the top-1 where the
golden's margin exceeds twice that, the logsumexp within 2^-8.  The
reason: the port's bf16 products and attention sum in other orders than
the reference's XLA on a CPU, so single bf16 values flip by one ulp in
every layer and the flips add up over the layers.

The MoE adds routing flips.  Those one-ulp differences reach its router
scores (scores of about 1.26 times a standard normal; the port on a CPU
against the reference on the same 1,024 tokens, layer 0: differences of
0.0029 at the median and 0.021 at most), while the gap between a
token's 8th and 9th score of 128 is below 2^-6 for 18 % of the tokens;
31 of 1,024 tokens took another expert in layer 0.  A token that does
moves its own logits by up to 0.8125 (the port on a CPU against this
golden), and a flip earlier in the prompt can change which assignments
an expert's capacity drops, the last tokens first.  So a position of
the MoE golden beyond ``logit_tol`` counts as a routing flip if its
top-8 are within ``MOE_FLIP_TOL`` = 1.0 and its logsumexp within 2^-8,
and at most ``MOE_FLIP_SHARE`` = a quarter of the positions may be
flips (the port on a CPU: 4 of 17).  ``--port-cpu`` runs the port on the
CPU against a golden and prints its errors: the two libraries' orders on
one host.

The tests here do not run the models: they check the files' format,
that the numpy synthesis still gives the capture's weights (a SHA-256 of
each leaf's first 4,096 float32 values and of every small leaf whole),
that the prompt draws again, and that ``chip_smoke.py`` uses these files
and tolerances.  The specs are held to the reference's leaf for leaf in
``tests/test_torch_dense.py``.

Regenerate with ``PYTHONPATH=src python tests/test_torch_qwen3_reference.py
--capture ARCH`` (in the background, one at a time, nothing else big
beside them: on an 8-core 62 GB CPU host qwen3-1.7b took 194 s and 11.0
GB of memory at its peak, the MoE 422 s and 49.6 GB).
"""
import dataclasses
import hashlib
import json
import pathlib
import sys
import time
from typing import Optional

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
# arch -> (golden file, layers run)
GOLDENS = {"qwen3-1.7b": ("torch_qwen3_1_7b_s1024.json", 28),
           "qwen3-moe-235b-a22b":
           ("torch_qwen3_moe_235b_a22b_l2_s1024.json", 2)}
SEED, PROMPT_SEED = 0, 0
PROMPT_LEN, DECODE_STEPS, TOPK = 1024, 16, 8
SMALL_LEAF = 1 << 20         # leaves with fewer elements are digested whole
HEAD = 4096                  # float32 values digested of every leaf
LSE_TOL = 2 ** -8
CTX_SEED = 1                 # the context of a model with context tokens
MOE_FLIP_TOL = 1.0
MOE_FLIP_SHARE = 0.25


def logit_tol(golden: dict) -> float:
    """4 bf16 ulps of the golden's largest top logit (phase 10's rule)."""
    top = max(abs(s["top"][0][1]) for s in golden["steps"])
    return 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


def prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(PROMPT_SEED).integers(
        0, vocab, (1, PROMPT_LEN), dtype=np.int32)


def step_record(logits, vocab: int) -> dict:
    """Top-k, margin and logsumexp of one position's logits [V_padded]."""
    x = np.asarray(logits, np.float32)[:vocab]
    order = np.lexsort((np.arange(vocab), -x))[:TOPK]
    x64 = x.astype(np.float64)
    lse = float(x64.max() + np.log(np.exp(x64 - x64.max()).sum()))
    return {"top": [[int(i), float(x[i])] for i in order],
            "margin": float(x[order[0]] - x[order[1]]), "lse": lse}


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32)
                          .tobytes()).hexdigest()


def leaf_digests(spec, index: int) -> dict:
    """``{"head": sha of the first HEAD values in C order, "all": sha of
    the whole leaf}`` (``all`` for leaves below ``SMALL_LEAF`` elements
    only).  The leaf's generator fills C order from one stream, so its
    first values are a 1-d draw of the same spec."""
    from repro_torch.models.common import spec_leaf_np
    size = int(np.prod(spec.shape))
    head = dataclasses.replace(spec, shape=(min(HEAD, size),))
    out = {"head": digest(spec_leaf_np(head, SEED, index))}
    if size < SMALL_LEAF:
        out["all"] = digest(spec_leaf_np(spec, SEED, index))
    return out


def context(n: int, d: int) -> np.ndarray:
    """The golden's context (vision tokens, audio frames) of a model with
    context tokens: ``[1, n, d]`` float32 standard normals from
    ``np.random.default_rng(CTX_SEED)``, which each framework rounds to
    bf16 (to nearest even), as the reference's stub frontend draws
    them."""
    return np.random.default_rng(CTX_SEED).standard_normal((1, n, d),
                                                           dtype=np.float32)


def capture_golden(path, cfg, specs, layers: int, meta: dict,
                   group_cut: Optional[int] = None, ctx=None,
                   edit=None) -> None:
    """Run the reference's ``cfg`` (its first ``layers`` layers) on the
    golden's prompt and write the golden to ``path``, ``meta`` added.

    The weights are the port's numpy draw of the whole model's ``specs``
    (leaf for leaf in the same order): each stacked leaf's first layers
    as ``group_rows`` counts them (of ``group_cut`` rows of the groups
    where a row is not a layer: a vision super-block), at the whole model's
    scales.  ``ctx`` (float32 numpy) is the context, rounded to bf16;
    ``edit(params)`` returns the parameter tree the run takes (the gates
    a golden sets)."""
    import resource

    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_test_mesh
    from repro.models.common import is_spec
    from repro.models.model import build_specs as jax_build_specs
    from repro.models.model import decode_step, prefill
    from repro.parallel.sharding import Sharder
    from repro_torch.models.common import (flatten_specs, group_rows,
                                           leaf_blocks_np)

    t_start = time.time()
    keep = group_rows(specs, layers if group_cut is None else group_cut)
    port_leaves = flatten_specs(specs)
    leaves, treedef = jax.tree.flatten(jax_build_specs(cfg), is_leaf=is_spec)
    assert len(leaves) == len(port_leaves)
    arrays, digests, n_bytes = [], {}, 0
    for i, (spec, (leaf, pspec)) in enumerate(zip(leaves, port_leaves)):
        rows = keep[leaf.split("/")[1]] if leaf.startswith("groups/") \
            else None
        want = tuple(pspec.shape) if rows is None else \
            (rows, *pspec.shape[1:])
        assert tuple(spec.shape) == want, leaf
        host = np.empty(want, jnp.dtype(spec.dtype))
        flat = host.reshape(-1)
        for lo, hi, block in leaf_blocks_np(pspec, SEED, i, rows=rows):
            flat[lo:hi] = np.asarray(
                jnp.asarray(block).astype(jnp.dtype(spec.dtype)))
        digests[leaf] = leaf_digests(pspec, i)
        arrays.append(jnp.asarray(host))
        n_bytes += host.nbytes
        del host, flat
    params = jax.tree.unflatten(treedef, arrays)
    del arrays
    if edit is not None:
        params = edit(params)
    print(f"weights: {n_bytes} bytes in {time.time() - t_start:.1f} s",
          flush=True)

    mesh = make_test_mesh()
    sh = Sharder(mesh)
    toks = prompt(cfg.vocab)
    batch = {"tokens": jnp.asarray(toks)}
    if ctx is not None:
        batch["ctx"] = jnp.asarray(ctx).astype(jnp.bfloat16)
    steps, tokens = [], []
    with jax.set_mesh(mesh):
        t0 = time.time()
        logits, cache = jax.jit(lambda p, b: prefill(p, b, cfg, sh))(
            params, batch)
        rec = step_record(np.asarray(logits[0, -1], np.float32), cfg.vocab)
        print(f"prefill: {time.time() - t0:.1f} s", flush=True)
        steps.append(rec)
        tokens.append(rec["top"][0][0])
        dec = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg, sh))
        for i in range(DECODE_STEPS):
            t0 = time.time()
            logits, cache = dec(params, cache,
                                jnp.asarray([[tokens[-1]]], jnp.int32),
                                jnp.int32(PROMPT_LEN + i))
            rec = step_record(np.asarray(logits[0, -1], np.float32),
                              cfg.vocab)
            steps.append(rec)
            tokens.append(rec["top"][0][0])
            print(f"decode step {i}: {time.time() - t0:.1f} s", flush=True)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out = {**meta, "layers": layers, "seed": SEED,
           "prompt_seed": PROMPT_SEED, "prompt_len": PROMPT_LEN,
           "decode_steps": DECODE_STEPS, "topk": TOPK, "vocab": cfg.vocab,
           "jax": jax.__version__, "leaf_sha256": digests, "tokens": tokens,
           "steps": steps, "capture_s": round(time.time() - t_start, 1),
           "capture_max_rss_bytes": rss}
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path.name} in {time.time() - t_start:.1f} s, max RSS "
          f"{rss} bytes", flush=True)


def capture(arch: str) -> None:
    """Run the reference on the golden's layers and write the golden."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_specs
    fname, layers = GOLDENS[arch]
    capture_golden(GOLDEN_DIR / fname,
                   dataclasses.replace(jax_get_config(arch), n_layers=layers),
                   build_specs(get_config(arch)), layers, {"arch": arch})


def port_against(golden: dict, full, layers: int,
                 group_cut: Optional[int] = None, ctx=None,
                 edit=None) -> None:
    """The port's ``full`` config cut to its first ``layers`` layers on the
    CPU (the same numpy draw; ``group_cut``, ``ctx`` and ``edit`` as
    :func:`capture_golden` takes them), teacher-forced on the golden's
    prompt and tokens; prints each position's errors against the
    golden."""
    import torch

    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_specs, decode_step, prefill
    cfg = dataclasses.replace(full, n_layers=layers)
    t0 = time.time()
    params = init_params(build_specs(full), SEED, "cpu", threads=4,
                         layers=layers if group_cut is None else group_cut)
    if edit is not None:
        params = edit(params)
    if ctx is not None:
        ctx = torch.from_numpy(ctx).to(torch.bfloat16)
    print(f"weights: {time.time() - t0:.1f} s", flush=True)
    tol, worst, beyond = logit_tol(golden), [0.0, 0.0], []

    def check(label, logits, ref):
        x = logits[:golden["vocab"]].float().numpy().astype(np.float64)
        top = float(max(abs(x[t] - v) for t, v in ref["top"]))
        lse = float(x.max() + np.log(np.exp(x - x.max()).sum()))
        worst[0], worst[1] = max(worst[0], top), \
            max(worst[1], abs(lse - ref["lse"]))
        if top > tol:
            beyond.append(label)
        print(f"{label}: top-8 max_abs_err {top!r}, logsumexp err "
              f"{abs(lse - ref['lse'])!r}, top-1 {int(np.argmax(x))} "
              f"(golden {ref['top'][0][0]}, margin {ref['margin']!r})",
              flush=True)
    toks = torch.as_tensor(prompt(golden["vocab"]))
    with torch.inference_mode():
        logits, cache = prefill(params, toks, cfg, ctx)
        check("prefill", logits[0, -1], golden["steps"][0])
        for i, tok in enumerate(golden["tokens"][:-1]):
            logits, cache = decode_step(params, cache, torch.tensor([[tok]]),
                                        PROMPT_LEN + i, cfg)
            check(f"decode step {i}", logits[0, -1], golden["steps"][i + 1])
    print(f"worst: top-8 {worst[0]!r} (tolerance {tol}), logsumexp "
          f"{worst[1]!r} (tolerance {LSE_TOL}); beyond {tol}: {beyond}; "
          f"{time.time() - t0:.1f} s")


def port_cpu(arch: str) -> None:
    from repro_torch.configs import get_config
    fname, layers = GOLDENS[arch]
    port_against(json.loads((GOLDEN_DIR / fname).read_text()),
                 get_config(arch), layers)


@pytest.fixture(scope="module", params=sorted(GOLDENS))
def golden(request):
    arch = request.param
    return arch, json.loads((GOLDEN_DIR / GOLDENS[arch][0]).read_text())


def test_golden_format(golden):
    arch, g = golden
    assert (g["arch"], g["layers"], g["seed"], g["prompt_seed"],
            g["prompt_len"], g["decode_steps"], g["topk"]) == \
        (arch, GOLDENS[arch][1], SEED, PROMPT_SEED, PROMPT_LEN,
         DECODE_STEPS, TOPK)
    steps = g["steps"]
    assert len(steps) == DECODE_STEPS + 1
    assert g["tokens"] == [s["top"][0][0] for s in steps]
    for s in steps:
        toks = [t for t, _ in s["top"]]
        vals = [v for _, v in s["top"]]
        assert len(toks) == TOPK and len(set(toks)) == TOPK
        assert all(0 <= t < g["vocab"] for t in toks)
        assert vals == sorted(vals, reverse=True)
        assert s["margin"] == vals[0] - vals[1] >= 0
        assert np.isfinite(s["lse"]) and s["lse"] >= vals[0]


def test_numpy_weights_reproduce_the_golden(golden):
    """The port's numpy synthesis gives the capture's float32 weights: the
    first values of every leaf and every small leaf whole, at full width
    and the whole model's depth (the cut golden's layers are its first)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    arch, g = golden
    leaves = flatten_specs(build_specs(get_config(arch)))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == g["leaf_sha256"]


def test_leaf_head_is_the_leaf_prefix():
    """The digest's head is the leaf's first values in C order."""
    from repro_torch.models.common import ParamSpec, spec_leaf_np
    spec = ParamSpec((3, 70, 40), scale=0.3)
    whole = spec_leaf_np(spec, SEED, 5).reshape(-1)
    head = dataclasses.replace(spec, shape=(HEAD,))
    np.testing.assert_array_equal(spec_leaf_np(head, SEED, 5), whole[:HEAD])


def test_prompt_draws_again(golden):
    _, g = golden
    toks = prompt(g["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < g["vocab"]


def test_chip_smoke_holds_the_card_to_these_goldens(golden):
    """``chip_smoke.py`` phases 22 and 23 read these files and derive the
    tolerance by this file's rule."""
    import importlib.util
    arch, g = golden
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.QWEN3[arch]["golden"].name == GOLDENS[arch][0]
    assert cs.QWEN3[arch]["layers"] == GOLDENS[arch][1]
    assert cs.logit_tol(g) == logit_tol(g) and cs.LSE_TOL == LSE_TOL
    assert (cs.MOE_FLIP_TOL, cs.MOE_FLIP_SHARE) == (MOE_FLIP_TOL,
                                                    MOE_FLIP_SHARE)


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 2 and args[0] in ("--capture", "--port-cpu") and \
            args[1] in GOLDENS:
        (capture if args[0] == "--capture" else port_cpu)(args[1])
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture ARCH | --port-cpu ARCH "
                 f"(ARCH in {sorted(GOLDENS)})")
