"""The port's non-causal flash attention against the reference's.

``flash_attention_ref(..., causal=False)`` (the plain version of the CUDA
kernel's non-causal form: an encoder's self-attention, a cross-attention
over a context) is held to the reference's Pallas kernel run with
``causal=False`` in interpret mode (where ``Skv`` is a multiple of its
64-key tiles), to its pure-jnp oracle ``attention_ref(causal=False)`` and
to the model's chunked ``attention_core(causal=False)``, at ragged
``Skv``, ``Sq`` above and below ``Skv``, GQA groups of 1 and 8, float32
and bf16 inputs.  Tolerances, with the reasons of
``tests/test_torch_flash_attention.py``:

* against the Pallas kernel with the same 64-key tiles: only the order of
  float32 sums differs, so float32 outputs agree to 1e-5 and bf16
  outputs to one bf16 rounding (2^-7 of the largest output);
* against ``attention_ref`` and ``attention_core``: those do not round
  ``p`` to bf16 before ``p·v`` or round it against another running max,
  which moves a bf16 output by up to about 2^-8 of the largest ``|v|``
  on top of its own rounding (2^-6 of the largest output); float32
  inputs agree to 1e-5.

Also: the kernel's tile schedule (``kernel.key_tiles``) covers every
pair once; a window is refused without causality, and the causal
``Sq > Skv`` still is; ``compare_bf16`` rejects the fault the kernel's
last tile must avoid (the zero rows past ``Skv`` taken as keys); the
bench's cases and bounds.  The CUDA kernel against its plain version
runs only on a host with a card: ``tests/test_torch_cross_card.py``
(marked ``gpu``, no JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import attention_core
from repro_torch.kernels.flash_attention import (flash_attention_op,
                                                 flash_attention_ref,
                                                 kernel, live_pairs)
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ref import BLOCK_K, compare_bf16

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Skv, H, Hkv, D, dtype):
    """Seeded q, k, v as (jax arrays, torch tensors) of one dtype; the
    torch tensors hold the jax arrays' values exactly."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    j = [jnp.asarray(a).astype(jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _check(got, want, dtype, bf16_share):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-5 if dtype == "f32" else bf16_share * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,dtype", [
    (1, 128, 64, 8, 8, 16, "f32"),      # Sq > Skv, g = 1
    (2, 64, 192, 8, 1, 32, "bf16"),     # Sq < Skv, g = 8
    (1, 192, 128, 16, 2, 64, "bf16"),   # Sq > Skv, g = 8
    (1, 128, 128, 4, 4, 64, "f32"),     # an encoder's square
])
def test_plain_matches_pallas_kernel_not_causal(B, Sq, Skv, H, Hkv, D, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Skv + D, B, Sq, Skv, H, Hkv, D,
                                      dtype)
    want = jax_flash(jq, jk, jv, causal=False, bq=64, bk=64, interpret=True)
    _check(flash_attention_ref(q, k, v, causal=False), want, dtype, 2 ** -7)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,dtype", [
    (1, 77, 1000 // 8, 8, 1, 16, "f32"),    # ragged both, g = 8
    (2, 200, 33, 8, 8, 32, "bf16"),         # Sq > Skv, one ragged tile
    (1, 50, 130, 16, 2, 64, "bf16"),        # Sq < Skv
    (1, 1, 70, 4, 4, 16, "f32"),            # one query
])
def test_plain_matches_attention_ref_not_causal(B, Sq, Skv, H, Hkv, D,
                                                dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq * Skv, B, Sq, Skv, H, Hkv, D, dtype)
    want = attention_ref(jq, jk, jv, causal=False)
    _check(flash_attention_ref(q, k, v, causal=False), want, dtype, 2 ** -6)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,dtype", [
    (1, 100, 100, 8, 1, 32, "f32"),         # ragged Skv, g = 8
    (1, 100, 100, 8, 1, 32, "bf16"),
    (2, 130, 65, 4, 4, 16, "bf16"),         # Sq > Skv, g = 1
    (1, 130, 65, 8, 1, 16, "f32"),
    (1, 40, 201, 8, 8, 32, "bf16"),         # Sq < Skv, g = 1
    (1, 40, 201, 16, 2, 16, "f32"),         # g = 8
])
def test_plain_matches_attention_core_not_causal(B, Sq, Skv, H, Hkv, D,
                                                 dtype):
    """The model's chunked core with 64-query and 64-key blocks, as the
    reduced configs run it (keys padded and masked past ``Skv``)."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq + 7 * Skv, B, Sq, Skv, H, Hkv, D,
                                      dtype)
    want = attention_core(jq, jk, jv, causal=False, q_block=64, kv_block=64)
    _check(flash_attention_ref(q, k, v, causal=False), want, dtype, 2 ** -6)


def test_op_dispatches_the_plain_version_on_the_cpu():
    """The op takes ``causal`` to the plain version on a CPU tensor and
    launches nothing."""
    _, (q, k, v) = _inputs(3, 1, 70, 30, 4, 2, 16, "bf16")
    before = kernel.launch_counts()["flash_attention"]
    got = flash_attention_op(q, k, v, causal=False)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=False))
    assert kernel.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, v, causal=False)


# (Sq, Skv): the models' (seamless-m4t's encoder and cross layer,
# llama-3.2-vision's cross layer) and ragged ones
SCHEDULE_SHAPES = [(1024, 1024), (4096, 1024), (4096, 1600), (1000, 1000),
                   (200, 1601), (1601, 77), (130, 1000), (77, 33), (1, 64),
                   (64, 1)]


@pytest.mark.parametrize("sq,skv", SCHEDULE_SHAPES)
def test_key_tile_schedule_covers_every_pair_once(sq, skv):
    """Not causal, each query tile walks every key tile, the last one
    holding the keys past the last full tile; every pair is visited
    exactly once and the pairs number ``live_pairs``."""
    seen = np.zeros((sq, skv), np.int16)
    sched = kernel.key_tiles(sq, skv, causal=False)
    assert [qt for qt, _, _ in sched] == list(range(len(sched)))[::-1]
    for qt, t_lo, t_hi in sched:
        assert (t_lo, t_hi) == (0, (skv - 1) // BLOCK_K)
        rows = slice(qt * kernel.BLOCK_Q, min((qt + 1) * kernel.BLOCK_Q, sq))
        for t in range(t_lo, t_hi + 1):
            seen[rows, t * BLOCK_K:min((t + 1) * BLOCK_K, skv)] += 1
    assert (seen == 1).all()
    assert live_pairs(sq, skv, causal=False) == sq * skv == int(seen.sum())
    live = fa_ref._mask(sq, skv, None, "cpu", causal=False).numpy()
    assert live.all() and live.shape == (sq, skv)


def test_shapes_the_non_causal_form_does_not_take_raise():
    """A window without causality raises (no model calls the pair and
    the Pallas kernel has none), in the plain version and the op; the
    causal ``Sq > Skv`` still raises, the non-causal one is taken."""
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention_ref(q, kv, kv, window=2, causal=False)
    with pytest.raises(ValueError, match="window"):
        flash_attention_op(q, kv, kv, window=0, causal=False)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention_ref(q, kv, kv)
    assert flash_attention_ref(q, kv, kv, causal=False).shape == (1, 8, 4, 16)
    with pytest.raises(ValueError, match="Skv >= 1"):
        flash_attention_ref(q, kv[:, :0], kv[:, :0], causal=False)


def test_kernel_check_rejects_keys_past_skv():
    """``compare_bf16`` passes the plain version's own output and rejects
    what a kernel gives that takes the zero rows past ``Skv`` in its last
    tile as keys (a score of 0 instead of NEG): keys padded with zeros to
    a multiple of 64, at llama's 1,000-key ragged case."""
    _, (q, k, v) = _inputs(17, 1, 256, 1000, 16, 2, 128, "bf16")
    want = flash_attention_ref(q, k, v, causal=False)
    assert compare_bf16(want, want, q, k, v, causal=False)["ok"]
    pad = 1024 - 1000
    kp, vp = (torch.cat([x, x.new_zeros((1, pad, 2, 128))], 1)
              for x in (k, v))
    bad = flash_attention_ref(q, kp, vp, causal=False)
    res = compare_bf16(bad, want, q, k, v, causal=False)
    assert not res["ok"], res
    # and the causal bound of the same inputs is another function
    assert fa_ref.max_weight(q[:, :100], k, causal=False).shape == \
        (1, 100, 16)


def test_bench_cross_cases_and_bounds():
    """``CASES_CROSS``: llama-3.2-vision-90b's cross layer, seamless's
    encoder and cross layer, the two models' causal self layers (timed),
    then ragged non-causal shapes; bounds at 989 TFLOP/s of 4 D
    operations a live pair: 0.434, 0.017, 0.069, 0.556 and 0.139 ms;
    every non-causal case is at a non-causal instantiation."""
    from repro_torch.kernels.flash_attention import bench
    cases = bench.CASES_CROSS
    assert cases[:bench.N_TIMED_CROSS] == [
        (2, 4096, 1600, 64, 8, 128, None, 128, False),
        (4, 1024, 1024, 16, 16, 64, None, 64, False),
        (4, 4096, 1024, 16, 16, 64, None, 64, False),
        (2, 4096, 4096, 64, 8, 128, None, 128, True),
        (4, 4096, 4096, 16, 16, 64, None, 64, True)]
    want = (0.434, 0.017, 0.069, 0.556, 0.139)
    for case, ms in zip(cases, want):
        got, by = bench.bound_ms(*case)
        assert by == "operations" and got == pytest.approx(ms, abs=5e-4)
    b, sq, skv, h, _, d = cases[0][:6]
    assert bench.bound_ms(*cases[0])[0] == pytest.approx(
        4 * d * b * h * sq * skv / bench.BF16_OPS_PER_S * 1e3)
    ragged = [c for c in cases if not c[8]][3:]
    assert any(c[2] % 64 for c in ragged)
    assert any(c[1] > c[2] for c in ragged)
    assert any(c[1] < c[2] for c in ragged)
    assert any(c[1] % 64 for c in ragged)
    assert all((c[5], c[7]) in kernel.NONCAUSAL_HEAD_DIMS
               for c in cases if not c[8])
    assert set(kernel.NONCAUSAL_HEAD_DIMS) <= set(kernel.HEAD_DIMS)
    # the MUFU ceiling counts every tile: 64 x 25 for each of the 128
    # (batch, head) pairs of llama's cross layer
    assert bench.ex2_ms(2, 4096, 1600, 64, None, False) == pytest.approx(
        128 * 64 * 25 * 64 * 64 / bench.EX2_PER_S * 1e3)
