"""The JAX reference's first two training steps of the two SSM archs.

Two goldens, each captured as ``tests/test_torch_train_reference.py``
captures qwen3-1.7b's (weights from the port's numpy synthesis,
``repro_torch.models.common.leaf_blocks_np``, seed 0, rounded to each
leaf's dtype; batches ``SyntheticLM(DataConfig(vocab, seq=512,
global_batch=1, seed=0)).batch_at(0)`` and ``batch_at(1)``; each step
``jax.value_and_grad(loss_fn)`` with ``remat="full"``, then
``adamw_update`` at lr 3e-4 with float32 moments):

* ``tests/golden/torch_hymba_1p5b_train_s512.json``: ``hymba-1.5b``
  whole (32 ``hybrid`` / ``hybrid_full`` layers, d 1,600, 25 heads on 5
  KV heads of 64, ``d_inner`` 3,200, full attention at layers 0, 15 and
  31, window 2,048);
* ``tests/golden/torch_falcon_mamba_7b_l4_train_s512.json``:
  ``falcon-mamba-7b`` at full width (d 4,096, ``d_inner`` 8,192, vocab
  65,024) cut to its first 4 of 64 ``mamba`` layers: each stacked leaf's
  first 4 layers, drawn at the 64-layer model's scales, so they are the
  whole model's first 4 layers.  The whole model does not train on one
  card: 7.27 B parameters at about 20 bytes each (bf16 parameters,
  float32 moments, gradients and the out-of-place update's second copy)
  are over 140 GB.

The reference differentiates its chunked scan (``lax.associative_scan``
inside a ``lax.scan`` over chunks, ``repro/models/ssm.py``) with XLA; the
port runs ``SelectiveScanFn``: the forward and backward kernels on the
card, their plain versions on the CPU.

A golden keeps what qwen3-1.7b's keeps (each step's loss, ``grad_norm``
and ``lr``; the float64 gradient and update norms of ``GRAD_LEAVES``:
the embeddings, the final norm and, at the first and last layer, the
scan's inputs ``ssm/A_log``, ``ssm/x_proj``, ``ssm/dt_w``, ``ssm/dt_b``,
``ssm/in_proj``, ``ssm/conv_w`` and the layer's ``ln1``, Hymba's
``attn/wq`` too; the leaf and batch SHA-256s, each listed leaf's size,
``capture_s`` and ``capture_max_rss_bytes``).

``chip_smoke.py`` phase 28 trains the port on the card from the same
weights and batches and holds it to each golden within its arch's
``tols``, by the rule of ``test_torch_train_reference.errors`` (loss absolute, the norms
relative, tighter at the first step than after it; the reasons are
stated there).  ``--port-cpu ARCH`` runs the port on the CPU against a
golden and prints its errors: the two libraries' orders on one host.

The tests here do not train the models: they check the files' format,
that the numpy synthesis still gives the captures' weights (a SHA-256 of
each leaf's first 4,096 float32 values and of every small leaf whole),
that falcon-mamba's 4 layers are the whole model's first 4, that the
batches draw again, and that ``chip_smoke.py`` uses these files and
tolerances.

Regenerate with ``PYTHONPATH=src python
tests/test_torch_train_ssm_reference.py --capture ARCH`` (in the
background, one at a time, nothing else big beside it: see
``capture_s`` and ``capture_max_rss_bytes`` in each golden).
"""
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_qwen3_reference import SEED, leaf_digests  # noqa: E402
from test_torch_train_reference import (BATCH, DATA_SEED, LR,  # noqa: E402
                                        SEQ, STEPS, leaf_at, leaf_size,
                                        norm64, token_digest)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
_SSM_LEAVES = ("ssm/A_log", "ssm/x_proj", "ssm/dt_w", "ssm/dt_b",
               "ssm/in_proj", "ssm/conv_w", "ln1")


def _grad_leaves(layers, extra=()) -> tuple:
    """The embeddings and final norm, then each ``(group, index)`` layer's
    scan inputs and ``extra`` leaves."""
    return ("embed", "unembed", "final_norm") + tuple(
        f"groups/{g}/{leaf}[{i}]" for g, i in layers
        for leaf in _SSM_LEAVES + tuple(extra))


# arch -> the golden's file, its layers of the whole model (None: all),
# its leaves (Hymba's layer 0 is group hf0's first and layer 31 group
# hf4's; falcon-mamba's layers 0 and 3 are group m's first and fourth),
# and its tolerances at the first step and after it, by the rule of
# test_torch_train_reference.errors, each from that arch's own gaps.
# Measured gaps (largest over the leaves), the port on an 8-core CPU host
# (--port-cpu) / on an H100 (chip_smoke phase 28), loss in nats, the rest
# relative:
# * Hymba: step 0 loss 0.00094 / 0.00119, grad_norm 0.009 % / 0.024 %,
#   leaves 0.29 % / 0.94 %, updates 1.30 % / 0.75 %; step 1 loss 0.0019 /
#   0.00003, grad_norm 1.14 % / 0.60 %, leaves 1.88 % / 6.95 %, updates
#   1.42 % / 2.45 %.  Its loss and grad_norm bounds are qwen3-1.7b's; the
#   leaves' are looser, for two of them: the last layer's ssm/x_proj,
#   whose gradient (2.5e-5) is a sum over tokens of the scan's dB, dC and
#   ddt terms that cancels to a small share of them, so bf16 flips in the
#   attention upstream move it most; and ssm/dt_w, whose gradient (2e-8 a
#   leaf) is near AdamW's eps, so its update depends on the gradient's
#   size and not only its sign.
# * falcon-mamba's 4 layers, where every gradient passes through the
#   scan's backward and no attention: step 0 loss 0.00013 / 0.00029,
#   grad_norm 0.0002 % / 0.0033 %, leaves 0.03 % / 0.025 %, updates
#   0.14 % / 0.023 %; step 1 loss 0.0005 / 0.00035, grad_norm 0.001 % /
#   0.0048 %, leaves 0.05 % / 0.087 %, updates 0.06 % / 0.058 %.  Its
#   bounds are 6-20 times those gaps.
ARCHES = {
    "hymba-1.5b": {
        "golden": GOLDEN_DIR / "torch_hymba_1p5b_train_s512.json",
        "layers": None,
        "grad_leaves": _grad_leaves((("hf0", 0), ("hf4", 0)),
                                    ("attn/wq",)),
        "tols": ({"loss": 0.005, "grad_norm": 0.005, "leaf": 0.02,
                  "update": 0.03},
                 {"loss": 0.02, "grad_norm": 0.08, "leaf": 0.15,
                  "update": 0.05})},
    "falcon-mamba-7b": {
        "golden": GOLDEN_DIR / "torch_falcon_mamba_7b_l4_train_s512.json",
        "layers": 4,
        "grad_leaves": _grad_leaves((("m", 0), ("m", 3))),
        "tols": ({"loss": 0.002, "grad_norm": 0.0005, "leaf": 0.005,
                  "update": 0.01},
                 {"loss": 0.003, "grad_norm": 0.001, "leaf": 0.01,
                  "update": 0.01})},
}


def configs(arch: str) -> tuple:
    """(the port's config of the golden's model, its specs for the
    weights): a cut model keeps the whole model's specs, whose first
    layers are drawn at the whole model's scales."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_specs
    full = get_config(arch)
    layers = ARCHES[arch]["layers"]
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    return cfg, build_specs(full)


def capture(arch: str) -> None:
    """Run the reference's two steps and write the golden."""
    import resource

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.mesh import make_test_mesh
    from repro.models.common import is_spec
    from repro.models.model import build_specs as jax_build_specs
    from repro.models.model import loss_fn
    from repro.optim.adamw import AdamWConfig, adamw_update, init_opt
    from repro.parallel.sharding import Sharder
    from repro_torch.models.common import flatten_specs, leaf_blocks_np

    t_start = time.time()
    spec = ARCHES[arch]
    layers, grad_leaves = spec["layers"], spec["grad_leaves"]
    full = jax_get_config(arch)
    assert full.remat == "full"
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    port_leaves = flatten_specs(configs(arch)[1])
    specs = jax_build_specs(cfg)
    leaves, treedef = jax.tree.flatten(specs, is_leaf=is_spec)
    assert len(leaves) == len(port_leaves)
    arrays, digests = [], {}
    for i, (leaf, (path, pspec)) in enumerate(zip(leaves, port_leaves)):
        stacked = layers is not None and path.startswith("groups/")
        want = (layers, *pspec.shape[1:]) if stacked else tuple(pspec.shape)
        assert tuple(leaf.shape) == want, path
        host = np.empty(want, jnp.dtype(leaf.dtype))
        flat = host.reshape(-1)
        for lo, hi, block in leaf_blocks_np(
                pspec, SEED, i, rows=layers if stacked else None):
            flat[lo:hi] = np.asarray(
                jnp.asarray(block).astype(jnp.dtype(leaf.dtype)))
        digests[path] = leaf_digests(pspec, i)
        arrays.append(jnp.asarray(host))
        del host, flat
    params = jax.tree.unflatten(treedef, arrays)
    del arrays
    print(f"weights: {time.time() - t_start:.1f} s", flush=True)

    opt = AdamWConfig(lr=LR)
    assert opt.state_dtype == "float32"
    opt_state = init_opt(specs, opt)
    mesh = make_test_mesh()
    sh = Sharder(mesh)
    data = SyntheticLM(DataConfig(cfg.vocab, SEQ, BATCH, seed=DATA_SEED))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg, sh)))
    update = jax.jit(lambda p, g, s: adamw_update(p, g, s, opt),
                     donate_argnums=(0, 2))
    steps, batches = [], []
    with jax.set_mesh(mesh):
        for step in range(STEPS):
            t0 = time.time()
            batch = data.batch_at(step)
            batches.append(token_digest(batch["tokens"]))
            loss, grads = grad_fn(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            norms = {name: norm64(leaf_at(grads, name))
                     for name in grad_leaves}
            before = {name: np.asarray(leaf_at(params, name), np.float32)
                      for name in grad_leaves}
            params, opt_state, metrics = update(params, grads, opt_state)
            del grads
            moved = {name: norm64(np.asarray(leaf_at(params, name),
                                             np.float32) - before[name])
                     for name in grad_leaves}
            del before
            steps.append({"loss": float(loss),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "leaf_grad_norms": norms,
                          "leaf_update_norms": moved})
            print(f"step {step}: {steps[-1]} in {time.time() - t0:.1f} s",
                  flush=True)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out = {"arch": arch, "layers": cfg.n_layers,
           "whole_layers": full.n_layers, "seed": SEED, "seq": SEQ,
           "global_batch": BATCH, "data_seed": DATA_SEED, "lr": LR,
           "state_dtype": "float32", "remat": cfg.remat, "vocab": cfg.vocab,
           "jax": jax.__version__, "leaf_sha256": digests,
           "batch_sha256": batches, "steps": steps,
           "sizes": {name: leaf_size(specs, name) for name in grad_leaves},
           "capture_s": round(time.time() - t_start, 1),
           "capture_max_rss_bytes": rss}
    spec["golden"].write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {spec['golden'].name} in {time.time() - t_start:.1f} s, "
          f"max RSS {rss} bytes", flush=True)


def errors(golden: dict, got: list) -> list:
    """``test_torch_train_reference.errors`` at the golden's arch's
    ``tols``: a dict a step of the absolute loss error, the relative ``grad_norm``
    error, the largest relative errors of the leaves' gradient and update
    norms, and ``ok``."""
    out, tols = [], ARCHES[golden["arch"]]["tols"]
    for i, (g, w) in enumerate(zip(got, golden["steps"])):
        tol = tols[min(i, 1)]
        e = {"loss": abs(g["loss"] - w["loss"]),
             "grad_norm": abs(g["grad_norm"] / w["grad_norm"] - 1),
             "leaf": max(abs(g["leaf_grad_norms"][k] / v - 1)
                         for k, v in w["leaf_grad_norms"].items()),
             "update": max(abs(g["leaf_update_norms"][k] / v - 1)
                           for k, v in w["leaf_update_norms"].items())}
        e["ok"] = all(e[k] <= tol[k] for k in tol) and \
            np.float32(g["lr"]) == np.float32(w["lr"])
        out.append(e)
    if len(got) != len(golden["steps"]):
        out.append({"ok": False})
    return out


def errors_ok(errs: list) -> bool:
    return all(e["ok"] for e in errs)


def port_cpu(arch: str) -> None:
    """The port's two steps on the CPU against the golden."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import grads_and_loss
    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt

    spec = ARCHES[arch]
    golden = json.loads(spec["golden"].read_text())
    t0 = time.time()
    cfg, whole = configs(arch)
    params = init_params(whole, SEED, "cpu", threads=4,
                         layers=spec["layers"])
    opt = AdamWConfig(lr=LR)
    opt_state = init_opt(build_specs(cfg), opt, "cpu")
    data = SyntheticLM(DataConfig(cfg.vocab, SEQ, BATCH, seed=DATA_SEED),
                       device="cpu")
    print(f"weights: {time.time() - t0:.1f} s", flush=True)
    got = []
    for step in range(STEPS):
        t1 = time.time()
        loss, grads = grads_and_loss(params, data.batch_at(step), cfg)
        norms = {name: norm64(leaf_at(grads, name).double())
                 for name in spec["grad_leaves"]}
        before = params
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt)
        del grads
        moved = {name: norm64((leaf_at(params, name).float()
                               - leaf_at(before, name).float()).double())
                 for name in spec["grad_leaves"]}
        del before
        got.append({"loss": float(loss),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]), "leaf_grad_norms": norms,
                    "leaf_update_norms": moved})
        w = golden["steps"][step]
        print(f"step {step} ({time.time() - t1:.1f} s): loss "
              f"{got[-1]['loss']!r} (golden {w['loss']!r}), grad_norm "
              f"{got[-1]['grad_norm']!r} (golden {w['grad_norm']!r})",
              flush=True)
        for k, v in w["leaf_grad_norms"].items():
            print(f"  {k}: {norms[k]!r} (golden {v!r}, rel "
                  f"{norms[k] / v - 1:+.3e}); update rel "
                  f"{moved[k] / w['leaf_update_norms'][k] - 1:+.3e}")
    errs = errors(golden, got)
    print(f"errors: {errs}; ok {errors_ok(errs)}; {time.time() - t0:.1f} s")


@pytest.fixture(scope="module")
def goldens():
    return {arch: json.loads(spec["golden"].read_text())
            for arch, spec in ARCHES.items()}


@pytest.mark.parametrize("arch", sorted(ARCHES))
def test_golden_format(goldens, arch):
    golden, spec = goldens[arch], ARCHES[arch]
    cfg, _ = configs(arch)
    assert (golden["arch"], golden["layers"], golden["seed"], golden["seq"],
            golden["global_batch"], golden["data_seed"], golden["lr"],
            golden["state_dtype"], golden["remat"], golden["vocab"]) == \
        (arch, cfg.n_layers, SEED, SEQ, BATCH, DATA_SEED, LR, "float32",
         "full", cfg.vocab)
    assert golden["whole_layers"] == (32 if arch == "hymba-1.5b" else 64)
    assert len(golden["steps"]) == STEPS == len(golden["batch_sha256"])
    for s in golden["steps"]:
        assert np.isfinite(s["loss"]) and 0 < s["loss"] < 2 * np.log(
            golden["vocab"])
        assert s["grad_norm"] > 0 and np.float32(s["lr"]) == np.float32(LR)
        for key in ("leaf_grad_norms", "leaf_update_norms"):
            assert tuple(s[key]) == spec["grad_leaves"]
            assert all(v > 0 and np.isfinite(v) for v in s[key].values())
        # an update moves a weight by about lr
        for k, v in s["leaf_update_norms"].items():
            assert v < 4 * LR * np.sqrt(golden["sizes"][k]), k
        assert sum(v * v for v in s["leaf_grad_norms"].values()) <= \
            s["grad_norm"] ** 2 * (1 + 1e-3)
    assert golden["capture_s"] > 0 and golden["capture_max_rss_bytes"] > 0


@pytest.mark.parametrize("arch", sorted(ARCHES))
def test_golden_sizes_are_the_cut_models(goldens, arch):
    """Each listed leaf's size is one layer's (or the whole leaf's) in
    the port's specs of the golden's model."""
    from repro_torch.models.model import build_specs
    cfg, _ = configs(arch)
    specs = build_specs(cfg)
    assert goldens[arch]["sizes"] == {
        name: leaf_size(specs, name) for name in ARCHES[arch]["grad_leaves"]}


@pytest.mark.parametrize("arch", sorted(ARCHES))
def test_numpy_weights_reproduce_the_golden(goldens, arch):
    from repro_torch.models.common import flatten_specs
    leaves = flatten_specs(configs(arch)[1])
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == goldens[arch]["leaf_sha256"]


def test_cut_layers_are_the_whole_models_first():
    """A depth cut draws each stacked leaf's first layers of the whole
    model's streams at its scales: at reduced size, falcon-mamba's first
    2 layers of ``init_params(layers=2)`` equal the whole draw's, and the
    cut config's specs have the cut's shapes."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.common import flatten_specs, init_params
    from repro_torch.models.model import build_specs
    cfg = reduced(get_config("falcon-mamba-7b"))
    specs = build_specs(cfg)
    whole = dict(flatten_specs(init_params(specs, SEED, "cpu")))
    cut = dict(flatten_specs(init_params(specs, SEED, "cpu", layers=2)))
    assert whole.keys() == cut.keys()
    for path, t in cut.items():
        w = whole[path]
        assert torch.equal(t, w[:2] if path.startswith("groups/") else w), \
            path
    cut_specs = dict(flatten_specs(build_specs(
        dataclasses.replace(cfg, n_layers=2))))
    assert {p: tuple(s.shape) for p, s in cut_specs.items()} == \
        {p: tuple(t.shape) for p, t in cut.items()}


@pytest.mark.parametrize("arch", sorted(ARCHES))
def test_batches_draw_again(goldens, arch):
    """The port's pipeline draws the golden's batches, as the reference's
    does."""
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    golden = goldens[arch]
    port = SyntheticLM(DataConfig(golden["vocab"], SEQ, BATCH,
                                  seed=DATA_SEED), device="cpu")
    ref = JaxSyntheticLM(JaxDataConfig(golden["vocab"], SEQ, BATCH,
                                       seed=DATA_SEED))
    for step, want in enumerate(golden["batch_sha256"]):
        b = port.batch_at(step)
        assert b["tokens"].shape == (BATCH, SEQ)
        assert token_digest(b["tokens"].numpy()) == want
        assert token_digest(ref.batch_at(step)["tokens"]) == want


@pytest.mark.parametrize("arch", sorted(ARCHES))
def test_errors_apply_the_tolerances(goldens, arch):
    golden = goldens[arch]
    same = [dict(s) for s in golden["steps"]]
    assert errors_ok(errors(golden, same))
    for key, tol in ARCHES[arch]["tols"][1].items():
        for step in range(STEPS):
            off = [dict(s) for s in golden["steps"]]
            if key == "loss":
                off[step]["loss"] += 2 * tol
            elif key == "grad_norm":
                off[step]["grad_norm"] *= 1 + 2 * tol
            else:
                name = "leaf_grad_norms" if key == "leaf" else \
                    "leaf_update_norms"
                off[step][name] = {k: v * (1 + 2 * tol) for k, v in
                                   off[step][name].items()}
            assert not errors_ok(errors(golden, off)), (key, step)
    lr = [dict(s, lr=2 * s["lr"]) for s in golden["steps"]]
    assert not errors_ok(errors(golden, lr))
    assert not errors_ok(errors(golden, same[:1]))


def test_chip_smoke_holds_the_card_to_these_goldens():
    """``chip_smoke.py`` phase 28 reads these files and tolerances."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    keys = ("golden", "layers", "grad_leaves", "tols")
    assert {arch: tuple(rec[k] for k in keys)
            for arch, rec in cs.SSM_TRAIN.items()} == \
        {arch: tuple(rec[k] for k in keys) for arch, rec in ARCHES.items()}
    assert (cs.TRAIN_SEQ, cs.TRAIN_BATCH, cs.TRAIN_STEPS, cs.TRAIN_LR) == \
        (SEQ, BATCH, STEPS, LR)


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--capture" and args[1] in ARCHES:
        capture(args[1])
    elif len(args) == 2 and args[0] == "--port-cpu" and args[1] in ARCHES:
        port_cpu(args[1])
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture ARCH | --port-cpu ARCH "
                 f"(ARCH in {sorted(ARCHES)})")
