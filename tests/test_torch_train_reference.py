"""The JAX reference's first two training steps of qwen3-1.7b at full width.

``tests/golden/torch_qwen3_1_7b_train_s512.json``: ``qwen3-1.7b``, all 28
layers (d 2,048, 16 query heads on 8 KV heads of 128, d_ff 6,144, vocab
151,936), trained by the reference package on the CPU for two steps:

* weights from the port's numpy synthesis
  (``repro_torch.models.common.leaf_blocks_np``, seed 0) rounded to each
  leaf's dtype, as the serving goldens take them;
* batches ``SyntheticLM(DataConfig(151936, seq=512, global_batch=1,
  seed=0)).batch_at(0)`` and ``batch_at(1)``;
* each step ``jax.value_and_grad(loss_fn)`` (``remat="full"``, the
  reference's default) then ``adamw_update`` with ``AdamWConfig(lr=3e-4)``
  and float32 moments: the reference's ``make_train_step``, split in two
  so that the gradients can be read.

Per step the golden keeps the loss, ``grad_norm`` and ``lr``, and for
each of ``GRAD_LEAVES`` (the embeddings, the final norm, and layers 0
and 27's ``wq``, ``wo``, ``mlp/wi``, ``mlp/wo`` and ``ln1``) the float64
norm of its gradient and of its update ``|p' - p|``; beside them the
leaf SHA-256s (as the serving goldens keep them), each batch's token
SHA-256 and each listed leaf's size.

``chip_smoke.py`` phase 27 trains the port on the card from the same
weights and batches and holds it to the golden within ``TOLS``: the
loss (absolute, nats), ``grad_norm``, and each leaf's gradient and
update norms (relative), tighter at the first step than after it.  The
reason for tolerances: the port's bf16 products and sums run in other
orders than the reference's XLA on a CPU, so bf16 values flip by one
ulp in every layer; and AdamW's first step moves each weight by about
``lr`` times the sign of its gradient, so an element whose gradient is
near zero may move the other way, and the second step's gradients start
from weights that differ that way.  The update norms do not depend on
those signs, so they stay tight.  ``--port-cpu`` runs the port on the
CPU against the golden and prints its errors: the two libraries' orders
on one host.

The tests here do not train the model: they check the file's format, that
the numpy synthesis still gives the capture's weights, that the batches
draw again, and that ``chip_smoke.py`` uses this file and its tolerances.

Regenerate with ``PYTHONPATH=src python tests/test_torch_train_reference.py
--capture`` (in the background, alone: see ``capture_s`` and
``capture_max_rss_bytes`` in the golden).
"""
import hashlib
import json
import pathlib
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_qwen3_reference import SEED, leaf_digests  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "torch_qwen3_1_7b_train_s512.json"
ARCH = "qwen3-1.7b"
SEQ, BATCH, DATA_SEED, STEPS, LR = 512, 1, 0, 2, 3e-4
LAYERS = (0, 27)
GRAD_LEAVES = ("embed", "unembed", "final_norm") + tuple(
    f"groups/d/{leaf}[{i}]" for i in LAYERS
    for leaf in ("attn/wq", "attn/wo", "mlp/wi", "mlp/wo", "ln1"))
# tolerances at the first step (the same weights: the gradients' sums in
# other orders) and after it (AdamW's first update moves each weight by
# about lr times the sign of its gradient, and where that gradient is
# near zero the sign may differ, so the weights and the next gradients
# drift apart; the norm of each leaf's update, |p' - p|, does not depend
# on those signs).  Measured gaps: the port on an 8-core CPU host
# (--port-cpu) and on an H100 (chip_smoke phase 27): step 0 loss 0.00226
# / 0.00083 nats, grad_norm 0.024 % / 0.016 %, leaves 0.16 % / 0.14 %;
# step 1 loss 0.00144 / 0.00136, grad_norm 0.89 % / 3.16 %, leaves
# 1.56 % / 3.42 %
TOLS = ({"loss": 0.005, "grad_norm": 0.005, "leaf": 0.01, "update": 0.01},
        {"loss": 0.02, "grad_norm": 0.08, "leaf": 0.10, "update": 0.02})


def token_digest(tokens) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens, np.int32)
                          .tobytes()).hexdigest()


def leaf_at(tree, name: str):
    """The array of ``GRAD_LEAVES`` entry ``name`` in a nested dict: a
    path, with ``[i]`` the layer of a stacked leaf."""
    path, _, layer = name.partition("[")
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node[int(layer[:-1])] if layer else node


def leaf_size(specs, name: str) -> int:
    """Elements of ``GRAD_LEAVES`` entry ``name`` in a spec tree (one
    layer's of a stacked leaf)."""
    path, _, layer = name.partition("[")
    node = specs
    for k in path.split("/"):
        node = node[k]
    return int(np.prod(node.shape[1:] if layer else node.shape))


def norm64(a) -> float:
    return float(np.sqrt(np.sum(np.square(np.asarray(a, np.float64)))))


def capture() -> None:
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
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs, leaf_blocks_np
    from repro_torch.models.model import build_specs

    t_start = time.time()
    cfg = jax_get_config(ARCH)
    assert cfg.remat == "full"
    port_leaves = flatten_specs(build_specs(get_config(ARCH)))
    specs = jax_build_specs(cfg)
    leaves, treedef = jax.tree.flatten(specs, is_leaf=is_spec)
    arrays, digests = [], {}
    for i, (spec, (path, pspec)) in enumerate(zip(leaves, port_leaves)):
        assert tuple(spec.shape) == tuple(pspec.shape), path
        host = np.empty(tuple(spec.shape), jnp.dtype(spec.dtype))
        flat = host.reshape(-1)
        for lo, hi, block in leaf_blocks_np(pspec, SEED, i):
            flat[lo:hi] = np.asarray(
                jnp.asarray(block).astype(jnp.dtype(spec.dtype)))
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
                     for name in GRAD_LEAVES}
            before = {name: np.asarray(leaf_at(params, name), np.float32)
                      for name in GRAD_LEAVES}
            params, opt_state, metrics = update(params, grads, opt_state)
            del grads
            moved = {name: norm64(np.asarray(leaf_at(params, name),
                                             np.float32) - before[name])
                     for name in GRAD_LEAVES}
            del before
            steps.append({"loss": float(loss),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "leaf_grad_norms": norms,
                          "leaf_update_norms": moved})
            print(f"step {step}: {steps[-1]} in {time.time() - t0:.1f} s",
                  flush=True)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out = {"arch": ARCH, "seed": SEED, "seq": SEQ, "global_batch": BATCH,
           "data_seed": DATA_SEED, "lr": LR, "state_dtype": "float32",
           "remat": cfg.remat, "vocab": cfg.vocab, "jax": jax.__version__,
           "leaf_sha256": digests, "batch_sha256": batches, "steps": steps,
           "sizes": {name: leaf_size(specs, name) for name in GRAD_LEAVES},
           "capture_s": round(time.time() - t_start, 1),
           "capture_max_rss_bytes": rss}
    GOLDEN.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {GOLDEN.name} in {time.time() - t_start:.1f} s, max RSS "
          f"{rss} bytes", flush=True)


def errors(golden: dict, got: list) -> list:
    """The port's steps ``got`` (``loss``, ``grad_norm``, ``lr``,
    ``leaf_grad_norms``, ``leaf_update_norms`` each) against the
    golden's, a dict a step: the absolute loss error, the relative
    ``grad_norm`` error, the largest relative errors of the leaves'
    gradient and update norms, and ``ok``: each within its tolerance
    (``TOLS[0]`` at the first step, ``TOLS[1]`` after it) and ``lr``
    equal."""
    out = []
    for i, (g, w) in enumerate(zip(got, golden["steps"])):
        tol = TOLS[min(i, 1)]
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


def port_cpu() -> None:
    """The port's two steps on the CPU against the golden."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import grads_and_loss
    from repro_torch.models.common import init_params
    from repro_torch.models.model import build_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt

    golden = json.loads(GOLDEN.read_text())
    t0 = time.time()
    cfg = get_config(ARCH)
    specs = build_specs(cfg)
    params = init_params(specs, SEED, "cpu", threads=4)
    opt = AdamWConfig(lr=LR)
    opt_state = init_opt(specs, opt, "cpu")
    data = SyntheticLM(DataConfig(cfg.vocab, SEQ, BATCH, seed=DATA_SEED),
                       device="cpu")
    print(f"weights: {time.time() - t0:.1f} s", flush=True)
    got = []
    for step in range(STEPS):
        t1 = time.time()
        loss, grads = grads_and_loss(params, data.batch_at(step), cfg)
        norms = {name: norm64(leaf_at(grads, name).double())
                 for name in GRAD_LEAVES}
        before = params
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt)
        del grads
        moved = {name: norm64((leaf_at(params, name).float()
                               - leaf_at(before, name).float()).double())
                 for name in GRAD_LEAVES}
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
                  f"{norms[k] / v - 1:+.3e})")
    del torch
    errs = errors(golden, got)
    print(f"errors: {errs}; ok {errors_ok(errs)}; {time.time() - t0:.1f} s")


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_format(golden):
    assert (golden["arch"], golden["seed"], golden["seq"],
            golden["global_batch"], golden["data_seed"], golden["lr"],
            golden["state_dtype"], golden["remat"]) == \
        (ARCH, SEED, SEQ, BATCH, DATA_SEED, LR, "float32", "full")
    assert len(golden["steps"]) == STEPS == len(golden["batch_sha256"])
    for s in golden["steps"]:
        assert np.isfinite(s["loss"]) and 0 < s["loss"] < 2 * np.log(
            golden["vocab"])
        assert s["grad_norm"] > 0 and np.float32(s["lr"]) == np.float32(LR)
        for key in ("leaf_grad_norms", "leaf_update_norms"):
            assert tuple(s[key]) == GRAD_LEAVES
            assert all(v > 0 and np.isfinite(v) for v in s[key].values())
        # an update moves a weight by about lr
        for k, v in s["leaf_update_norms"].items():
            assert v < 4 * LR * np.sqrt(golden["sizes"][k]), k
    # the leaves' norms are parts of the whole
    for s in golden["steps"]:
        assert sum(v * v for v in s["leaf_grad_norms"].values()) <= \
            s["grad_norm"] ** 2 * (1 + 1e-3)
    assert golden["capture_s"] > 0 and golden["capture_max_rss_bytes"] > 0


def test_numpy_weights_reproduce_the_golden(golden):
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_specs
    from repro_torch.models.model import build_specs
    leaves = flatten_specs(build_specs(get_config(ARCH)))
    got = {path: leaf_digests(spec, i)
           for i, (path, spec) in enumerate(leaves)}
    assert got == golden["leaf_sha256"]


def test_batches_draw_again(golden):
    """The port's pipeline draws the golden's batches, as the reference's
    does."""
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    port = SyntheticLM(DataConfig(golden["vocab"], SEQ, BATCH,
                                  seed=DATA_SEED), device="cpu")
    ref = JaxSyntheticLM(JaxDataConfig(golden["vocab"], SEQ, BATCH,
                                       seed=DATA_SEED))
    for step, want in enumerate(golden["batch_sha256"]):
        b = port.batch_at(step)
        assert b["tokens"].shape == (BATCH, SEQ)
        assert token_digest(b["tokens"].numpy()) == want
        assert token_digest(ref.batch_at(step)["tokens"]) == want


def test_leaf_at_reads_a_layer():
    tree = {"groups": {"d": {"ln1": np.arange(6.0).reshape(3, 2)}},
            "embed": np.ones(3)}
    np.testing.assert_array_equal(leaf_at(tree, "groups/d/ln1[2]"), [4, 5])
    assert norm64(leaf_at(tree, "embed")) == np.sqrt(3)


def test_errors_apply_the_tolerances(golden):
    same = [dict(s) for s in golden["steps"]]
    assert errors_ok(errors(golden, same))
    for key, tol in TOLS[1].items():
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


def test_chip_smoke_holds_the_card_to_this_golden():
    """``chip_smoke.py`` phase 27 reads this file and these tolerances."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.TRAIN_GOLDEN == GOLDEN
    assert cs.TRAIN_TOLS == TOLS
    assert cs.TRAIN_GRAD_LEAVES == GRAD_LEAVES
    assert (cs.TRAIN_SEQ, cs.TRAIN_BATCH, cs.TRAIN_STEPS, cs.TRAIN_LR) == \
        (SEQ, BATCH, STEPS, LR)


if __name__ == "__main__":
    if sys.argv[1:] == ["--capture"]:
        capture()
    elif sys.argv[1:] == ["--port-cpu"]:
        port_cpu()
    else:
        sys.exit(f"usage: {sys.argv[0]} --capture | --port-cpu")
