"""The JAX reference's greedy run of the full-width Hymba-1.5B.

``tests/golden/torch_hymba_1p5b_s4096.json`` records one request served by
the reference package on the CPU: the full ``hymba-1.5b`` config (32
layers, width 1,600) with weights from the port's numpy synthesis
(``repro_torch.models.common.spec_leaf_np``, seed 0) rounded to each
leaf's dtype, one prompt of 4,096 tokens drawn with
``np.random.default_rng(0)``, the prefill, then 16 greedy decode steps.
At the prefill and at each step it keeps the greedy token, the top-8
``(token, logit)`` over the real vocabulary (ties to the lower index),
the top-1/top-2 margin and the ``logsumexp`` in float64 of the bf16
logits.  ``chip_smoke.py`` holds the port on the card to it.

The tests here do not run the model: they check the file's format, that
the numpy synthesis still gives the capture's weights bit for bit (a
SHA-256 of each checked leaf's float32 bytes), that the prompt draws
again, and that the port's parameter specs equal the reference's.

Regenerate with ``PYTHONPATH=src python tests/test_torch_hymba_reference.py
--capture`` (about five minutes on an 8-core CPU host, with 3.3 GB of bf16
weights in memory; run it in the background).
"""
import hashlib
import json
import pathlib
import sys
import time

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_hymba_1p5b_s4096.json"
ARCH, SEED, PROMPT_SEED = "hymba-1.5b", 0, 0
PROMPT_LEN, DECODE_STEPS, TOPK = 4096, 16, 8
FIRST_LEAVES = 4             # checked whatever their size
SMALL_LEAF = 1 << 20         # and every leaf with fewer elements


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


def checked_leaf(i: int, spec) -> bool:
    return i < FIRST_LEAVES or int(np.prod(spec.shape)) < SMALL_LEAF


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32)
                          .tobytes()).hexdigest()


def capture() -> None:
    """Run the reference and write the golden."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_test_mesh
    from repro.models.common import is_spec
    from repro.models.model import build_specs as jax_build_specs
    from repro.models.model import decode_step, prefill
    from repro.parallel.sharding import Sharder
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs, spec_leaf_np
    from repro_torch.models.model import build_specs

    t_start = time.time()
    cfg = jax_get_config(ARCH)
    port_leaves = flatten_specs(build_specs(get_config(ARCH)))
    jax_specs = jax_build_specs(cfg)
    leaves, treedef = jax.tree.flatten(jax_specs, is_leaf=is_spec)
    assert len(leaves) == len(port_leaves)
    arrays, digests = [], {}
    for i, (spec, (path, pspec)) in enumerate(zip(leaves, port_leaves)):
        assert tuple(spec.shape) == tuple(pspec.shape), path
        a = spec_leaf_np(pspec, SEED, i)
        if checked_leaf(i, pspec):
            digests[path] = digest(a)
        arrays.append(jnp.asarray(a).astype(jnp.dtype(spec.dtype)))
        del a
    params = jax.tree.unflatten(treedef, arrays)
    print(f"weights: {time.time() - t_start:.1f} s", flush=True)

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
    out = {"arch": ARCH, "seed": SEED, "prompt_seed": PROMPT_SEED,
           "prompt_len": PROMPT_LEN, "decode_steps": DECODE_STEPS,
           "topk": TOPK, "vocab": cfg.vocab, "jax": jax.__version__,
           "leaf_sha256": digests, "tokens": tokens, "steps": steps,
           "capture_s": round(time.time() - t_start, 1)}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {GOLDEN} in {time.time() - t_start:.1f} s", flush=True)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["seed"], golden["prompt_seed"],
            golden["prompt_len"], golden["decode_steps"], golden["topk"]) == \
        (ARCH, SEED, PROMPT_SEED, PROMPT_LEN, DECODE_STEPS, TOPK)
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
    np.testing.assert_allclose(rec["lse"],
                               np.log(3 * np.e ** 2 + np.e + 12), rtol=1e-12)


def test_numpy_weights_reproduce_the_golden(golden):
    """The port's numpy synthesis gives the capture's float32 weights bit
    for bit: the first leaves and every small one, at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs, spec_leaf_np
    from repro_torch.models.model import build_specs
    leaves = flatten_specs(build_specs(get_config(ARCH)))
    got = {path: digest(spec_leaf_np(spec, SEED, i))
           for i, (path, spec) in enumerate(leaves) if checked_leaf(i, spec)}
    assert got == golden["leaf_sha256"]
    assert list(got)[:FIRST_LEAVES] == [p for p, _ in leaves[:FIRST_LEAVES]]


def test_prompt_draws_again(golden):
    toks = prompt(golden["vocab"])
    assert toks.shape == (1, PROMPT_LEN)
    assert toks.min() >= 0 and toks.max() < golden["vocab"]


def test_port_specs_equal_the_reference_specs():
    """Same leaves in the same order, with the same shape, dtype, init and
    scale, at full width: the numpy synthesis indexes leaves by order."""
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
        assert (tuple(r.shape), r.dtype, r.init, r.scale) == \
            (tuple(s.shape), s.dtype, s.init, s.scale)


if __name__ == "__main__":
    if "--capture" in sys.argv[1:]:
        capture()
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture")
