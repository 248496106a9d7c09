"""The gradient of the port's flash attention, on the CPU.

``kernels.flash_attention.FlashAttentionFn`` (the op's forward, the
plain version on the CPU, and ``backward.attention_backward``) is held,
in every form the forward takes — head dims 16, 64 and 128, MLA's
queries and keys of 192 with values of 128, causal with ``Sq <= Skv``
(queries at the end of the keys), a sliding window, not causal at (64,
64) and (128, 128) with ``Sq`` above and below a ragged ``Skv``, GQA
groups of 1, 2 and 8, several query blocks — against:

* ``torch.autograd`` through ``flash_attention_ref``, the forward's
  plain version, on the same bf16 inputs;
* ``jax.grad`` of the reference's ``repro.models.attention
  .attention_core`` (the jnp core the reference trains through) on the
  same inputs and output gradient.

Tolerance: ``GRAD_TOL`` = 2^-6 of the largest magnitude of the
reference's gradient, per tensor.  Each side ends in one bf16 rounding
(2^-8 relative) and sums in float32 in other orders; the two forwards
also round ``p`` to bf16 before ``p·v`` where this backward keeps
float32 ``p``.  Measured here over these cases and two seeds, as a
share of the largest value: at most 2^-7.1 against the plain version's
autograd, 2^-6.7 against the reference's gradient, and 2^-8.0 against
float64 autograd of the plain version.

A ``gpu``-marked test skips without a card: the card's gradients (the
CUDA forward kernel, the same backward) against autograd through the
plain version on the card (the scan's gradient on the card is
``tests/test_torch_scan_grad.py``'s).  This file imports JAX only inside the tests that use it, so
that the card's tests run where JAX is not installed (``python -m pytest
--noconftest -m gpu tests/test_torch_flash_grad.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 attention_backward,
                                                 flash_attention_op,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.backward import key_range

GRAD_TOL = 2 ** -6

# (B, Sq, Skv, H, Hkv, Dqk, Dv, window, causal)
CASES = {
    "d16-g2": (2, 48, 48, 4, 2, 16, 16, None, True),
    "d64-g1-window": (1, 96, 96, 4, 4, 64, 64, 20, True),
    "d64-g8-sq<skv": (1, 40, 72, 8, 1, 64, 64, None, True),
    "d128-g2": (1, 64, 64, 4, 2, 128, 128, None, True),
    "d128-g8-window-sq<skv": (1, 33, 77, 8, 1, 128, 128, 16, True),
    "mla-192-128": (1, 40, 40, 4, 4, 192, 128, None, True),
    "noncausal-64-ragged": (2, 37, 53, 4, 2, 64, 64, None, False),
    "noncausal-64-sq>skv": (1, 70, 19, 8, 1, 64, 64, None, False),
    "noncausal-128-g2": (1, 24, 40, 4, 2, 128, 128, None, False),
}
Q_BLOCK = 16        # several query blocks at these lengths


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed: int = 0):
    B, Sq, Skv, H, Hkv, D, Dv, _, _ = case
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)
    return (bf16(B, Sq, H, D), bf16(B, Skv, Hkv, D), bf16(B, Skv, Hkv, Dv),
            bf16(B, Sq, H, Dv))


def _grads(fn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    return o.detach(), torch.autograd.grad(o, (q, k, v), do)


def _jax_grads(case, q, k, v, do):
    """``jax.grad`` of ``attention_core`` on the same bf16 inputs."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import attention_core
    _, Sq, Skv, _, _, _, _, window, causal = case

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    def f(q, k, v):
        return attention_core(q, k, v, causal=causal, window=window,
                              q_block=Q_BLOCK, kv_block=Q_BLOCK,
                              q_offset=Skv - Sq if causal else 0)
    _, vjp = jax.vjp(f, j(q), j(k), j(v))
    return [torch.from_numpy(np.asarray(g, np.float32))
            for g in vjp(j(do))]


def _close(got, want, label):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= GRAD_TOL * scale, (label, err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_is_autograd_of_the_plain_version(name):
    case = CASES[name]
    window, causal = case[7], case[8]
    q, k, v, do = _inputs(case)
    o, got = _grads(lambda *a: flash_attention_op(*a, window, causal),
                    q, k, v, do)
    o_ref, want = _grads(lambda *a: flash_attention_ref(*a, window, causal),
                         q, k, v, do)
    assert torch.equal(o, o_ref)
    for g, w, t, label in zip(got, want, (q, k, v), "qkv"):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, f"d{label}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_is_the_references(name):
    case = CASES[name]
    window, causal = case[7], case[8]
    q, k, v, do = _inputs(case, seed=1)
    _, got = _grads(lambda *a: flash_attention_op(*a, window, causal),
                    q, k, v, do)
    for g, w, label in zip(got, _jax_grads(case, q, k, v, do), "qkv"):
        _close(g, w, f"d{label}")


@pytest.mark.parametrize("q_block", [7, 16, 512])
def test_query_blocks_do_not_change_the_gradient(q_block):
    """The blocks only bound the live scores: any block size gives the
    same sums over keys, and the key ranges cover every live key."""
    case = CASES["d64-g1-window"]
    q, k, v, do = _inputs(case)
    o = flash_attention_ref(q, k, v, case[7])
    whole = attention_backward(q, k, v, o, do, case[7], q_block=10 ** 6)
    part = attention_backward(q, k, v, o, do, case[7], q_block=q_block)
    for a, b in zip(whole, part):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * float(a.float().abs()
                                                        .max()))


def test_key_range_covers_the_mask():
    from repro_torch.kernels.flash_attention.ref import _mask
    for sq, skv, window in ((30, 30, None), (20, 45, 7), (64, 64, 0)):
        live = _mask(sq, skv, window, "cpu")
        for q0 in range(0, sq, 6):
            q1 = min(q0 + 6, sq)
            lo, hi = key_range(q0, q1, sq, skv, window)
            cols = live[q0:q1].any(0).nonzero().flatten()
            assert int(cols.min()) == lo and int(cols.max()) == hi - 1
    assert key_range(3, 9, 10, 17, None, causal=False) == (0, 17)


def test_no_grad_runs_the_forward_only():
    """Without autograd the op is the forward's dispatch: the same
    output, nothing kept for a backward."""
    case = CASES["d16-g2"]
    q, k, v, _ = _inputs(case)
    with torch.inference_mode():
        o = flash_attention_op(q, k, v)
    assert o.grad_fn is None
    assert torch.equal(o, flash_attention_ref(q, k, v))
    assert FlashAttentionFn.apply(q, k, v, None, True).grad_fn is None


@pytest.mark.gpu
def test_card_gradient_is_autograd_of_the_plain_version():
    """On the card: the CUDA forward kernel under the same backward,
    against autograd through the plain version on the card, at every
    form the kernel is instantiated for; the kernel launches once a
    forward."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for name, case in sorted(CASES.items()):
        D, Dv, window, causal = case[5:]
        dims = kernel.HEAD_DIMS if causal else kernel.NONCAUSAL_HEAD_DIMS
        if (D, Dv) not in dims:
            continue
        q, k, v, do = (t.cuda() for t in _inputs(case))
        kernel.reset_launch_counts()
        _, got = _grads(lambda *a: flash_attention_op(*a, window, causal),
                        q, k, v, do)
        assert kernel.launch_counts()["flash_attention"] == 1
        _, want = _grads(lambda *a: flash_attention_ref(*a, window, causal),
                         q, k, v, do)
        for g, w, label in zip(got, want, "qkv"):
            _close(g.cpu(), w.cpu(), f"{name} d{label}")

