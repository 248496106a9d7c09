"""The non-causal attention kernel and the cross-attention models on the
card.

The CUDA kernel's non-causal form against its plain version
(``compare_bf16``) at ragged shapes: ``Skv`` not a multiple of 64 (the
last tile's rows past ``Skv``, which TMA fills with zeros, must be
masked), ``Sq`` above and below ``Skv``, groups 1, 4 and 8, head dims 64
and 128; the wrapper's refusal of a non-causal pair of head dims it is
not built for; then the reduced ``seamless-m4t-medium`` and
``llama-3.2-vision-90b`` at the full configs' head dims (64 and 128)
with the port's seeded numpy weights: one ``flash_attention`` launch an
encoder layer, two a decoder layer, ``cross_every`` a vision
super-block, none a decode step.  Marked ``gpu`` and skipped on a host
without a card (run on the card with ``python -m pytest -m gpu
tests/test_torch_cross_card.py``).  The numbers are held to the
reference on the CPU by ``tests/test_torch_cross_attention.py``,
``tests/test_torch_vision.py`` and ``tests/test_torch_encdec.py``; this
file imports no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.common import init_params
from repro_torch.models.model import build_specs, decode_step, prefill


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", [
    (2, 256, 256, 16, 16, 64), (1, 200, 1601, 16, 16, 64),
    (2, 1601, 77, 8, 2, 64), (1, 1000, 1000, 16, 2, 128),
    (1, 130, 1000, 64, 8, 128), (3, 77, 33, 4, 4, 64)])
def test_cuda_kernel_matches_plain_version_not_causal(B, Sq, Skv, H, Hkv, D):
    _card()
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import (compare_bf16,
                                                         flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    got = kernel.flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, H, D)
    assert compare_bf16(got, want, q, k, v, causal=False)["ok"]
    with pytest.raises(ValueError, match="not causal"):
        kernel.flash_attention(*(x[..., :16].contiguous() for x in (q, k, v)),
                               causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,head_dim", [("seamless-m4t-medium", 64),
                                           ("llama-3.2-vision-90b", 128)])
def test_prefill_launches_the_kernel_in_every_attention(arch, head_dim):
    """One launch an ``enc`` layer, two a ``dec`` layer, ``cross_every`` a
    ``vision_super`` block, none a decode step; over a context of 100
    tokens (not a multiple of 64)."""
    _card()
    from repro_torch.kernels.flash_attention import kernel as fa
    cfg = dataclasses.replace(reduced(get_config(arch)), n_heads=4,
                              n_kv_heads=2, head_dim=head_dim)
    params = init_params(build_specs(cfg), 0, "cuda")
    toks = torch.zeros((2, 64), dtype=torch.int64, device="cuda")
    ctx = torch.randn((2, 100, cfg.d_model), device="cuda").to(
        torch.bfloat16)
    want = cfg.enc_layers + 2 * cfg.n_layers if cfg.enc_dec else \
        cfg.n_layers
    fa.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = prefill(params, toks, cfg, ctx)
        assert fa.launch_counts()["flash_attention"] == want
        decode_step(params, cache, toks[:, :1], 64, cfg)
    torch.cuda.synchronize()
    assert fa.launch_counts()["flash_attention"] == want
    assert torch.isfinite(logits.float()).all()
