"""The port's serving CLI, ``python -m repro_torch.launch.serve``.

Run as a user runs it, at the reduced Hymba on the CPU: it prints the
reference CLI's JSON fields (``arch``, ``generated``, ``wall_s``,
``sample``), and its tokens are ``ServeSession.generate``'s on the same
seeded weights and prompts.  Without ``--device`` it runs on the card,
so on a host without one it exits with an error.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import ServeSession

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)


def test_cli_serves_the_reduced_hymba_on_the_cpu():
    proc = _cli("--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                "--batch", "3", "--prompt-len", "24", "--max-new", "5")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"arch", "generated", "wall_s", "sample"}
    assert out["arch"] == "hymba-1.5b-smoke"
    assert out["generated"] == [3, 5]
    cfg = reduced(get_config("hymba-1.5b"))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 24),
                                                dtype=np.int32)
    want = ServeSession(cfg, device="cpu").generate(prompts, 5)
    assert out["sample"] == want[0].tolist()


def test_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    proc = _cli("--arch", "hymba-1.5b", "--reduced", "--batch", "1",
                "--prompt-len", "8", "--max-new", "2")
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_cli_serves_the_reduced_context_models_on_the_cpu(arch):
    """A model with context tokens: the CLI draws the context (16 tokens
    at reduced size) after the prompts from the same generator, as the
    reference's CLI does, and gives ``ServeSession.generate``'s tokens
    over it."""
    proc = _cli("--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "12", "--max-new", "3")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-smoke" and out["generated"] == [2, 3]
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
    ctx = rng.normal(size=(2, cfg.n_ctx_tokens, cfg.d_model))
    assert ctx.shape == (2, 16, 128)
    want = ServeSession(cfg, device="cpu").generate(prompts, 3, ctx)
    assert out["sample"] == want[0].tolist()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-235b-a22b"])
def test_cli_serves_the_reduced_qwen3_models_on_the_cpu(arch):
    proc = _cli("--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "16", "--max-new", "3")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-smoke" and out["generated"] == [2, 3]
    cfg = reduced(get_config(arch))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16),
                                                dtype=np.int32)
    want = ServeSession(cfg, device="cpu").generate(prompts, 3)
    assert out["sample"] == want[0].tolist()
