"""The Qwen3 models on the card: the attention kernel at head dim 128, one
``flash_attention`` launch a layer a prefill and none in a decode step,
and the MoE block's bits on two runs.

The reduced ``qwen3-1.7b`` and ``qwen3-moe-235b-a22b`` at head dim 128
(the full configs' head dim, the rest of the reduced shapes kept) with
the port's seeded numpy weights; marked ``gpu`` and skipped on a host
without a card (run on the card with ``python -m pytest -m gpu
tests/test_torch_qwen3_card.py``).  The models' numbers are held to the
reference on the CPU by ``tests/test_torch_dense.py`` and
``tests/test_torch_moe.py``; this file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.common import init_params
from repro_torch.models.model import build_specs, decode_step, prefill

ARCHS = ("qwen3-1.7b", "qwen3-moe-235b-a22b")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _model(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), head_dim=128)
    return cfg, init_params(build_specs(cfg), 0, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,window", [
    (2, 256, 256, 16, 8, None), (1, 200, 200, 64, 4, None),
    (1, 130, 300, 16, 2, 40), (2, 77, 77, 8, 8, None)])
def test_kernel_at_head_dim_128_matches_plain_version(B, Sq, Skv, H, Hkv,
                                                      window):
    _card()
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import (compare_bf16,
                                                         flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(Sq)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((B, Sq, H, 128), (B, Skv, Hkv, 128),
                         (B, Skv, Hkv, 128)))
    got = kernel.flash_attention(q, k, v, window=window)
    want = flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert compare_bf16(got, want, q, k, v, window)["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_launches_attention_once_per_layer(arch):
    _card()
    from repro_torch.kernels.flash_attention import kernel as fa
    cfg, params = _model(arch)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)), device="cuda")
    fa.reset_launch_counts()
    with torch.inference_mode():
        _, cache = prefill(params, toks, cfg)
        assert fa.launch_counts()["flash_attention"] == cfg.n_layers
        decode_step(params, cache, toks[:, :1], 64, cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_attention"] == cfg.n_layers


@pytest.mark.gpu
def test_moe_prefill_gives_the_same_bits_twice():
    _card()
    cfg, params = _model("qwen3-moe-235b-a22b")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 96)), device="cuda")
    with torch.inference_mode():
        a, ca = prefill(params, toks, cfg)
        b, cb = prefill(params, toks, cfg)
    assert torch.equal(a, b)
    assert all(torch.equal(ca[g][k], cb[g][k]) for g in ca for k in ca[g])
