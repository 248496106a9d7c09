"""The port's training step, optimizer state, fault-tolerant driver,
step builders and abstract inputs against the reference's, on the CPU.

The companion of ``tests/test_torch_train.py`` (the loss and every
leaf's gradient of one arch of each block kind), split from it so that
each file runs in well under a minute.  Weights and batches as there
(``test_torch_train._setup``).  Checked:

* three ``make_train_step`` steps against the reference's on
  ``qwen3-1.7b`` at ``reduced`` size, from the reference's zero
  optimizer state carried across by ``convert.opt_state_from_jax``:
  losses and gradient norms to ``STEP_LOSS_TOL`` / ``STEP_RTOL``, ``lr``
  and ``step`` equal, and the parameters after them each within ``2 lr``
  a step plus one bf16 ulp of the leaf's largest value and to
  ``STEP_PARAM_RTOL`` in relative L2 norm (AdamW's first steps move a
  weight by about ``lr`` times the sign of its gradient, so a gradient
  near zero may move it the other way: measured at most 0.0032 at lr
  0.001 after 3 steps);
* ``convert.opt_state_from_jax`` with bf16 moments and its shape check;
* ``build_training`` surviving a fault injected mid-run
  (``tests/test_system.py``'s case), its restored run bitwise the
  uninterrupted run: losses, parameters, moments and the int32 ``step``;
  and converging on the structured stream (``tests/test_system.py``'s
  ``test_train_loss_decreases``, the reference's own bound);
* ``make_prefill_step`` / ``make_decode_step``, ``input_structs`` of
  every cell against the reference's (``meta`` tensors against
  ``ShapeDtypeStruct``\\ s), ``default_opt`` and the CLI.
"""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_test_mesh as jax_test_mesh
from repro.models.model import build_specs as jax_build_specs
from repro.optim import adamw as jax_adamw
from repro.parallel.sharding import Sharder
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.convert import opt_state_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.models.common import flatten_specs
from repro_torch.models.model import build_specs, decode_step, prefill
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from repro_torch.runtime.fault_tolerance import FTConfig

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_train import B, S, _leaf, _rel, _setup  # noqa: E402

STEP_LOSS_TOL = 2 ** -9
STEP_RTOL = 2 ** -5
STEP_PARAM_RTOL = 2 ** -5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_steps_match_the_reference():
    """Three ``make_train_step`` steps on three batches from one state,
    the optimizer's taken from the reference's ``init_opt``."""
    arch = "qwen3-1.7b"
    jcfg, cfg, jp, params, _, _ = _setup(arch)
    opt = dict(lr=1e-3, schedule=None)
    jopt = jax_adamw.AdamWConfig(**opt)
    specs = jax_build_specs(jcfg)
    jstate = jax_adamw.init_opt(specs, jopt)
    state = opt_state_from_jax(jax.device_get(jstate), cfg, "cpu")
    assert state["step"].dtype == torch.int32
    data = SyntheticLM(DataConfig(cfg.vocab, S, B, seed=4), device="cpu")
    mesh = jax_test_mesh()
    sh = Sharder(mesh)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, sh, jopt))
    step = steps.make_train_step(cfg, AdamWConfig(**opt))
    for i in range(3):
        b = data.batch_np(i)
        with jax.set_mesh(mesh):
            jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        params, state, m = step(params, state, data.batch_at(i))
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_LOSS_TOL
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            <= STEP_RTOL
        assert np.float32(m["lr"]) == np.float32(jm["lr"])
        assert int(state["step"]) == int(jstate["step"]) == i + 1
    jp = jax.device_get(jp)
    for path, _ in flatten_specs(build_specs(cfg)):
        g = _leaf(params, path).float().numpy()
        w = np.asarray(_leaf(jp, path), np.float32)
        bound = 2 * opt["lr"] * 3 + 2 ** -8 * np.abs(w).max()
        assert np.abs(g - w).max() <= bound, path
        assert _rel(g, w) <= STEP_PARAM_RTOL, path


def test_opt_state_from_jax_carries_bf16_moments():
    jcfg, cfg = jax_reduced(jax_get_config("qwen3-1.7b")), \
        reduced(get_config("qwen3-1.7b"))
    jstate = jax.device_get(jax_adamw.init_opt(
        jax_build_specs(jcfg), jax_adamw.AdamWConfig(state_dtype="bfloat16")))
    jstate["step"] = np.int32(7)
    state = opt_state_from_jax(jstate, cfg, "cpu")
    assert state["m"]["embed"].dtype == torch.bfloat16
    assert int(state["step"]) == 7 and state["step"].dim() == 0
    with pytest.raises(ValueError, match="embed"):
        bad = dict(jstate, m=dict(jstate["m"], embed=np.zeros((3, 3),
                                                              np.float32)))
        opt_state_from_jax(bad, cfg, "cpu")


def _training(tmp_path, fault_at=None, steps_=20):
    cfg = reduced(get_config("qwen3-1.7b"))
    data = SyntheticLM(DataConfig(cfg.vocab, seq=32, global_batch=2),
                       device="cpu")
    crashed = {"done": False}

    def fault_hook(step):
        if step == fault_at and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated preemption")

    state, runner, ckpt = train.build_training(
        cfg, AdamWConfig(lr=1e-3), str(tmp_path), data,
        ft=FTConfig(ckpt_every=5, max_retries=2), fault_hook=fault_hook,
        device="cpu")
    runner.sleep_fn = lambda s: None
    state, step, hist = runner.run(state, 0, steps_)
    return state, step, hist, runner, ckpt


def test_build_training_survives_a_mid_run_fault(tmp_path):
    """The reference's case: a fault at step 12 with checkpoints every 5
    steps; the run restores step 10 and goes on to 20.  The restored
    run's losses and final state equal an uninterrupted run's bit for
    bit (the stream is counter-based, the CPU's sums deterministic)."""
    state, step, hist, runner, ckpt = _training(tmp_path / "a", 12)
    assert step == 20 and runner.restarts == 1
    assert len(hist) == 22 and ckpt.all_steps() == [10, 15, 20]
    clean, cstep, chist, crunner, _ = _training(tmp_path / "b")
    assert cstep == 20 and crunner.restarts == 0
    # steps 0-11 then, from the checkpoint of step 10, steps 10-19
    assert [h["loss"] for h in hist[:12]] == \
        [h["loss"] for h in chist[:12]]
    assert [h["loss"] for h in hist[12:]] == \
        [h["loss"] for h in chist[10:]]
    (p, o), (cp, co) = state, clean
    for path, _ in flatten_specs(build_specs(reduced(get_config(
            "qwen3-1.7b")))):
        assert torch.equal(_leaf(p, path), _leaf(cp, path)), path
        assert torch.equal(_leaf(o["m"], path), _leaf(co["m"], path))
    assert int(o["step"]) == int(co["step"]) == 20
    assert o["step"].dtype == torch.int32
    assert _leaf(p, "groups/d/attn/wq").dtype == torch.bfloat16


def test_step_builders_wrap_prefill_and_decode():
    _, cfg, _, params, _, tb = _setup("qwen3-1.7b", seq=16)
    with torch.no_grad():
        lg, cache = steps.make_prefill_step(cfg)(params, tb)
        lg2, _ = prefill(params, tb["tokens"], cfg)
        assert torch.equal(lg, lg2)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        c2 = {g: {k: v.clone() for k, v in c.items()}
              for g, c in cache.items()}
        out, _ = steps.make_decode_step(cfg)(params, cache, tok, 16)
        want, _ = decode_step(params, c2, tok, 16, cfg)
        assert torch.equal(out, want)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b",
                                  "deepseek-v3-671b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_input_structs_match_the_reference(arch):
    """The abstract inputs of every cell, shapes and dtypes, as the
    reference's ``ShapeDtypeStruct``\\ s (its decode cache included)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    sh = Sharder(jax_test_mesh())
    for name, cell in SHAPES.items():
        got = steps.input_structs(cfg, cell)
        want = jax_steps.input_structs(jcfg, cell, sh,
                                       jax_steps.default_opt(jcfg))
        gl = flatten_specs(got)
        wl = flatten_specs(want)
        assert [p for p, _ in gl] == [p for p, _ in wl], name
        for (path, g), (_, w) in zip(gl, wl):
            assert g.device.type == "meta", path
            assert tuple(g.shape) == tuple(w.shape), (name, path)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (name, path)


def test_default_opt_is_the_references():
    for arch in ("qwen3-1.7b", "qwen3-moe-235b-a22b", "deepseek-v3-671b"):
        got = steps.default_opt(get_config(arch))
        want = jax_steps.default_opt(jax_get_config(arch))
        assert got.state_dtype == want.state_dtype, arch
    assert steps.default_opt(get_config("deepseek-v3-671b")).state_dtype \
        == "bfloat16"


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "3",
                "--seq", "16", "--global-batch", "2", "--ckpt-dir",
                str(tmp_path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "falcon-mamba-7b-smoke" and out["steps"] == 3
    assert set(out) == {"arch", "steps", "first_loss", "last_loss",
                        "wall_s", "stragglers", "restarts"}
    assert np.isfinite(out["last_loss"]) and out["restarts"] == 0


def test_build_training_converges(tmp_path):
    """The reference's convergence case (``tests/test_system.py``): the
    reduced ``qwen3-1.7b`` on the structured stream, 4 x 64, AdamW lr
    1e-3 with ``warmup_cosine(5, 50)``: the mean of the last 5 of 50
    losses at least 0.3 below the first 5's."""
    cfg = reduced(get_config("qwen3-1.7b"))
    data = SyntheticLM(DataConfig(cfg.vocab, seq=64, global_batch=4),
                       device="cpu")
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(5, 50))
    state, runner, _ = train.build_training(cfg, opt, str(tmp_path), data,
                                            device="cpu")
    _, step, hist = runner.run(state, 0, 50)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert step == 50
    assert last < first - 0.3, (first, last)
