"""The JAX reference's greedy run of the full-width falcon-mamba-7b.

``tests/golden/torch_falcon_mamba_7b_s1024.json`` records one request
served by the reference package on the CPU: the ``falcon-mamba-7b``
config at full width (d 4,096, ``d_inner`` 8,192, state 16, vocab
65,024) and ``layers`` of its 64 layers, with weights from the port's
numpy synthesis (``repro_torch.models.common.spec_leaf_np``, seed 0)
rounded to each leaf's dtype, one prompt of 1,024 tokens drawn with
``np.random.default_rng(0)``, the prefill, then 16 greedy decode steps.
A stacked leaf is drawn a block at a time
(``leaf_blocks_np``), so the host never holds a float32 leaf; a golden
of fewer than 64 layers takes each stacked leaf's first slabs at the
64-layer scales, which are the whole model's first layers.  At the
prefill and at each step it keeps the greedy token, the top-8 ``(token,
logit)`` over the real vocabulary (ties to the lower index), the
top-1/top-2 margin and the ``logsumexp`` in float64 of the bf16 logits.
``chip_smoke.py`` phase 21 holds the port on the card to it.

The card is held to it (``chip_smoke.py``'s ``FALCON_LOGIT_TOL`` and
``LSE_TOL``, which equal ``LOGIT_TOL`` and ``LSE_TOL`` here) by phase
10's rule, with a reason: the port's bf16 products and its one-pass scan
sum in other orders than the reference's XLA on a CPU, so single bf16
values flip by one ulp in every layer and the flips add up over 64
layers; the top-8 logits (about 5.5 here, where a bf16 ulp is 2^-5) are
held to 4 ulps of the top logit, 2^-3 (phase 10's 2^-4 is 4 ulps of
Hymba's logits of about 3), the top-1 where the golden's margin exceeds
twice that, and the logsumexp, a softmax-weighted mean of the logits'
errors, to 2^-8.  ``--port-cpu`` runs the port on the CPU (about 3
minutes on 8 cores, 15 GB of memory) and prints its errors against the
golden: the same two libraries' orders on one host.

The tests here do not run the model: they check the file's format, that
the numpy synthesis still gives the capture's weights (a SHA-256 of each
leaf's first row of float32 bytes, and of every small leaf whole), that
the prompt draws again, and that the port's specs equal the reference's
leaf for leaf, sharding axes included.

Regenerate with ``PYTHONPATH=src python
tests/test_torch_falcon_mamba_reference.py --capture [--layers L]`` (run
it in the background; the capture prints its seconds and the weights'
bytes).
"""
import hashlib
import json
import pathlib
import sys
import time

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_falcon_mamba_7b_s1024.json"
ARCH, SEED, PROMPT_SEED = "falcon-mamba-7b", 0, 0
PROMPT_LEN, DECODE_STEPS, TOPK = 1024, 16, 8
SMALL_LEAF = 1 << 20         # leaves with fewer elements are digested whole
LOGIT_TOL = 2 ** -3          # 4 bf16 ulps of a top logit of about 5.5
LSE_TOL = 2 ** -8


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
    """``{"row0": sha of the first row, "all": sha of the whole leaf}``
    (``all`` for leaves below ``SMALL_LEAF`` elements only)."""
    from repro_torch.models.common import spec_leaf_np
    out = {"row0": digest(spec_leaf_np(spec, SEED, index, rows=1))}
    if int(np.prod(spec.shape)) < SMALL_LEAF:
        out["all"] = digest(spec_leaf_np(spec, SEED, index))
    return out


def capture(layers: int) -> None:
    """Run the reference on ``layers`` layers and write the golden."""
    import dataclasses
    import resource

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models.common import is_spec
    from repro.models.model import build_specs as jax_build_specs
    from repro.models.model import decode_step, prefill
    from repro.parallel.sharding import Sharder
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs, leaf_blocks_np
    from repro_torch.models.model import build_specs

    t_start = time.time()
    full = jax_get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    # the weights are the 64-layer model's: each stacked leaf's first
    # `layers` slabs, drawn at the whole model's scales
    port_leaves = flatten_specs(build_specs(get_config(ARCH)))
    leaves, treedef = jax.tree.flatten(jax_build_specs(cfg), is_leaf=is_spec)
    assert len(leaves) == len(port_leaves)
    arrays, digests, n_bytes = [], {}, 0
    for i, (spec, (path, pspec)) in enumerate(zip(leaves, port_leaves)):
        stacked = path.startswith("groups/")
        want = (layers, *pspec.shape[1:]) if stacked else tuple(pspec.shape)
        assert tuple(spec.shape) == want, path
        host = np.empty(want, jnp.dtype(spec.dtype))
        flat = host.reshape(-1)
        for lo, hi, block in leaf_blocks_np(
                pspec, SEED, i, rows=layers if stacked else None):
            flat[lo:hi] = np.asarray(
                jnp.asarray(block).astype(jnp.dtype(spec.dtype)))
        digests[path] = leaf_digests(pspec, i)
        arrays.append(jnp.asarray(host))
        n_bytes += host.nbytes
        del host, flat
    params = jax.tree.unflatten(treedef, arrays)
    print(f"weights: {n_bytes} bytes in {time.time() - t_start:.1f} s",
          flush=True)

    mesh = make_test_mesh()
    sh = Sharder(mesh)
    toks = prompt(cfg.vocab)
    steps, tokens = [], []
    with jax.set_mesh(mesh):
        t0 = time.time()
        logits, cache = jax.jit(lambda p, b: prefill(p, b, cfg, sh))(
            params, {"tokens": jnp.asarray(toks)})
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
    out = {"arch": ARCH, "layers": layers, "seed": SEED,
           "prompt_seed": PROMPT_SEED, "prompt_len": PROMPT_LEN,
           "decode_steps": DECODE_STEPS, "topk": TOPK, "vocab": cfg.vocab,
           "jax": jax.__version__, "leaf_sha256": digests, "tokens": tokens,
           "steps": steps, "capture_s": round(time.time() - t_start, 1),
           "capture_max_rss_bytes": rss}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {GOLDEN} in {time.time() - t_start:.1f} s, max RSS {rss} "
          "bytes", flush=True)


def port_cpu() -> None:
    """The port's model on the CPU, teacher-forced on the golden's prompt
    and tokens; prints each position's errors against the golden."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_specs, decode_step, prefill
    golden = json.loads(GOLDEN.read_text())
    cfg = get_config(ARCH)
    assert golden["layers"] == cfg.n_layers
    t0 = time.time()
    params = init_params(build_specs(cfg), SEED, "cpu", threads=4)
    print(f"weights: {time.time() - t0:.1f} s", flush=True)
    worst = [0.0, 0.0]

    def check(label, logits, ref):
        x = logits[:golden["vocab"]].float().numpy().astype(np.float64)
        top = float(max(abs(x[t] - v) for t, v in ref["top"]))
        lse = float(x.max() + np.log(np.exp(x - x.max()).sum()))
        worst[0], worst[1] = max(worst[0], top), \
            max(worst[1], abs(lse - ref["lse"]))
        print(f"{label}: top-8 max_abs_err {top!r}, logsumexp err "
              f"{abs(lse - ref['lse'])!r}, top-1 {int(np.argmax(x))} "
              f"(golden {ref['top'][0][0]}, margin {ref['margin']!r})",
              flush=True)
    toks = torch.as_tensor(prompt(golden["vocab"]))
    with torch.inference_mode():
        logits, cache = prefill(params, toks, cfg)
        check("prefill", logits[0, -1], golden["steps"][0])
        for i, tok in enumerate(golden["tokens"][:-1]):
            logits, cache = decode_step(params, cache, torch.tensor([[tok]]),
                                        PROMPT_LEN + i, cfg)
            check(f"decode step {i}", logits[0, -1], golden["steps"][i + 1])
    print(f"worst: top-8 {worst[0]!r} (tolerance {LOGIT_TOL}), logsumexp "
          f"{worst[1]!r} (tolerance {LSE_TOL}); {time.time() - t0:.1f} s")


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["seed"], golden["prompt_seed"],
            golden["prompt_len"], golden["decode_steps"], golden["topk"]) == \
        (ARCH, SEED, PROMPT_SEED, PROMPT_LEN, DECODE_STEPS, TOPK)
    assert 1 <= golden["layers"] <= 64
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


def test_step_record_orders_ties_by_index():
    x = np.zeros(20, np.float32)
    x[[3, 7, 11]] = 2.0
    x[15] = 1.0
    rec = step_record(x, vocab=16)
    assert [t for t, _ in rec["top"]] == [3, 7, 11, 15, 0, 1, 2, 4]
    assert rec["margin"] == 0.0


def test_numpy_weights_reproduce_the_golden(golden):
    """The port's numpy synthesis gives the capture's float32 weights: the
    first row of every leaf (a stacked leaf's first layer) and every small
    leaf whole, at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    leaves = flatten_specs(build_specs(get_config(ARCH)))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == golden["leaf_sha256"]


def test_prompt_draws_again(golden):
    toks = prompt(golden["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < golden["vocab"]


def test_port_specs_equal_the_reference_specs():
    """Same leaves in the same order, with the same shape, dtype, init,
    scale and sharding axes, at full width: the numpy synthesis indexes
    leaves by order."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.common import is_spec
    from repro.models.model import build_specs as jax_build_specs
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    ref = jax.tree.flatten_with_path(jax_build_specs(jax_get_config(ARCH)),
                                     is_leaf=is_spec)[0]
    port = flatten_specs(build_specs(get_config(ARCH)))
    assert ["/".join(k.key for k in kp) for kp, _ in ref] == \
        [p for p, _ in port]
    for (_, r), (_, s) in zip(ref, port):
        assert (tuple(r.shape), r.dtype, r.init, r.scale, tuple(r.axes)) == \
            (tuple(s.shape), s.dtype, s.init, s.scale, tuple(s.axes))


def test_chip_smoke_holds_the_card_to_these_tolerances(golden):
    """``chip_smoke.py`` phase 21 uses this file's tolerances, and the
    golden's top logits are where 2^-3 is 4 bf16 ulps ([4, 8))."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert (cs.FALCON_LOGIT_TOL, cs.LSE_TOL) == (LOGIT_TOL, LSE_TOL)
    assert cs.FALCON_GOLDEN.name == GOLDEN.name
    tops = [s["top"][0][1] for s in golden["steps"]]
    assert all(4 <= t < 8 for t in tops)
    assert LOGIT_TOL == 4 * 2.0 ** (np.floor(np.log2(max(tops))) - 7)


if __name__ == "__main__":
    if "--capture" in sys.argv[1:]:
        args = sys.argv[1:]
        capture(int(args[args.index("--layers") + 1])
                if "--layers" in args else 64)
    elif "--port-cpu" in sys.argv[1:]:
        port_cpu()
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture [--layers L] | "
                 "--port-cpu")
