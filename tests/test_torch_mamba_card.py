"""falcon-mamba's prefill on the card: one ``selective_scan`` launch a
layer, no ``flash_attention`` launch, and none in a decode step.

The reduced ``falcon-mamba-7b`` with the port's seeded numpy weights;
marked ``gpu`` and skipped on a host without a card (run on the card
with ``python -m pytest -m gpu tests/test_torch_mamba_card.py``).  The
model's numbers are held to the reference on the CPU by
``tests/test_torch_mamba.py``; this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.common import init_params
from repro_torch.models.model import build_specs, decode_step, prefill


@pytest.mark.gpu
def test_prefill_launches_the_scan_once_per_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.selective_scan import kernel as ss
    cfg = reduced(get_config("falcon-mamba-7b"))
    params = init_params(build_specs(cfg), 0, "cuda")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)), device="cuda")
    fa.reset_launch_counts()
    ss.reset_launch_counts()
    with torch.inference_mode():
        _, cache = prefill(params, toks, cfg)
        assert ss.launch_counts()["selective_scan"] == cfg.n_layers
        assert fa.launch_counts()["flash_attention"] == 0
        decode_step(params, cache, toks[:, :1], 64, cfg)
    torch.cuda.synchronize()
    assert ss.launch_counts()["selective_scan"] == cfg.n_layers
    assert fa.launch_counts()["flash_attention"] == 0
