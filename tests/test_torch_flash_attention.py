"""The port's flash attention against the reference's.

``flash_attention_ref`` (the plain version of the CUDA kernel) is held to
the reference's Pallas kernel run in interpret mode (no window; the
Pallas kernel has none), to its pure-jnp oracle ``attention_ref``
(window ``None`` or ``w``, ragged lengths, ``Sq < Skv``) and to the
model's chunked ``attention_core`` on its sliding-window branch, all
causal (the only form the model calls).  GQA groups of 1 and 5, float32
and bf16 inputs.  Tolerances, with reasons:

* against the Pallas kernel with the same 64-key tiles: the arithmetic is
  the same and only the order of float32 sums differs, so float32
  outputs agree to 1e-5 and bf16 outputs to one bf16 rounding (2^-7 of
  the largest output);
* against ``attention_ref`` and ``attention_core``: those do not round
  ``p`` to bf16 before ``p·v`` (``attention_ref``) or round it against
  another running max (``attention_core``'s blocks), which moves a bf16
  output by up to about 2^-8 of the largest ``|v|`` on top of the output's
  own rounding; float32 inputs agree to 1e-5.

The CUDA kernel against its plain version runs only on a host with a
card (marked ``gpu``).
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

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


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
    jdt, tdt = DTYPES[dtype][1], DTYPES[dtype][2]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    j = [jnp.asarray(a).astype(jdt) for a in arrs]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _tol(want: np.ndarray, dtype: str, bf16_share: float) -> float:
    return 1e-5 if dtype == "f32" else bf16_share * float(np.abs(want).max())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,D,dtype", [
    (1, 128, 5, 5, 16, "f32"),      # g = 1
    (2, 128, 5, 1, 32, "bf16"),     # g = 5
    (1, 192, 10, 2, 64, "f32"),     # g = 5
    (1, 256, 5, 1, 64, "bf16"),     # g = 5, four tiles
])
def test_plain_matches_pallas_kernel(B, S, H, Hkv, D, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + D, B, S, S, H, Hkv, D, dtype)
    want = _f32(jax_flash(jq, jk, jv, causal=True, bq=64, bk=64,
                          interpret=True))
    got = _f32(flash_attention_ref(q, k, v))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tol(want, dtype, 2 ** -7))


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window,dtype", [
    (1, 77, 77, 5, 5, 16, None, "f32"),     # ragged S, g = 1
    (2, 77, 77, 5, 1, 16, None, "bf16"),    # ragged S, g = 5
    (1, 130, 130, 5, 1, 32, 40, "bf16"),    # window across tiles
    (1, 130, 130, 5, 5, 16, 40, "f32"),
    (1, 150, 150, 5, 1, 16, 5, "f32"),      # first tiles wholly masked
    (1, 150, 150, 5, 1, 16, 5, "bf16"),
    (1, 70, 70, 5, 1, 16, 0, "f32"),        # window 0: a query sees itself
    (2, 50, 130, 10, 2, 32, None, "bf16"),  # Sq < Skv
    (1, 50, 130, 5, 1, 16, 20, "f32"),
])
def test_plain_matches_attention_ref(B, Sq, Skv, H, Hkv, D, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Skv, B, Sq, Skv, H, Hkv, D,
                                      dtype)
    want = _f32(attention_ref(jq, jk, jv, causal=True, window=window))
    got = _f32(flash_attention_ref(q, k, v, window=window))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tol(want, dtype, 2 ** -6))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_windowed_attention_core(dtype):
    """The model's sliding-window branch (Skv > window + 2 q_block)."""
    S, window = 200, 32
    (jq, jk, jv), (q, k, v) = _inputs(7, 1, S, S, 5, 1, 16, dtype)
    want = _f32(attention_core(jq, jk, jv, causal=True, window=window,
                               q_block=64, kv_block=64))
    got = _f32(flash_attention_ref(q, k, v, window=window))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tol(want, dtype, 2 ** -6))


@pytest.mark.parametrize("sq,skv,window", [
    (77, 77, None), (130, 130, 40), (50, 130, 20), (150, 150, 0)])
def test_live_pairs_counts_the_mask(sq, skv, window):
    qpos = np.arange(sq)[:, None] + skv - sq
    kpos = np.arange(skv)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - (window + 1)
    assert live_pairs(sq, skv, window) == int(mask.sum())


def test_shapes_the_kernel_does_not_take_raise():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention_ref(q, kv, kv)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_ref(torch.zeros((1, 4, 3, 16)), kv, kv)


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, _, _), (q, k, v) = _inputs(0, 1, 64, 64, 5, 1, 16, "bf16")
    before = kernel.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, v)
    flash_attention_op(q, k, v, window=8)
    assert kernel.launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("mutation", [None, -1, 1, -3, "tile"])
def test_kernel_check_rejects_a_wrong_window(mutation, monkeypatch):
    """``compare_bf16``, the check of the CUDA kernel against its plain
    version, passes the plain version's own output and rejects the
    outputs of a window a few keys off, or of one key tile dropped for one
    query tile, at a window of 512 keys."""
    S, W = 1024, 512
    _, (q, k, v) = _inputs(11, 1, S, S, 5, 1, 64, "bf16")
    want = flash_attention_ref(q, k, v, window=W)
    if mutation == "tile":
        mask = fa_ref._mask

        def drop_tile(*args):
            live = mask(*args).clone()
            live[512:576, 256:320] = False
            return live
        with monkeypatch.context() as m:
            m.setattr(fa_ref, "_mask", drop_tile)
            got = flash_attention_ref(q, k, v, window=W)
    else:
        got = flash_attention_ref(q, k, v, window=W + (mutation or 0))
    res = compare_bf16(got, want, q, k, v, W)
    assert res["ok"] == (mutation is None), res


# (Sq, Skv, window) of chip_smoke.py's phase 9 and of the gpu test below
SCHEDULE_SHAPES = [(4096, 4096, None), (4096, 4096, 2048), (1000, 1000, 300),
                   (77, 333, None), (130, 130, 5), (200, 200, 64),
                   (256, 256, None), (256, 256, 100), (77, 77, None),
                   (150, 150, 5), (50, 130, 20), (100, 100, None)]


@pytest.mark.parametrize("sq,skv,window", SCHEDULE_SHAPES)
def test_key_tile_schedule_covers_the_mask_once(sq, skv, window):
    """The CUDA kernel's tile schedule (mirrored by ``kernel.key_tiles``):
    its grid takes the query tiles from the last to the first, the key
    tiles its blocks visit hold every live (query, key) pair of the mask
    exactly once, and no visited tile is wholly masked for its query
    tile."""
    live = fa_ref._mask(sq, skv, window, "cpu").numpy()
    seen = np.zeros(live.shape, np.int16)
    sched = kernel.key_tiles(sq, skv, window)
    assert [qt for qt, _, _ in sched] == list(range(len(sched)))[::-1]
    for qt, t_lo, t_hi in sched:
        rows = slice(qt * kernel.BLOCK_Q, min((qt + 1) * kernel.BLOCK_Q, sq))
        for t in range(t_lo, t_hi + 1):
            cols = slice(t * BLOCK_K, min((t + 1) * BLOCK_K, skv))
            assert live[rows, cols].any(), (qt, t)
            seen[rows, cols] += 1
    assert (seen[live] == 1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window", [
    (2, 256, 256, 25, 5, 64, None), (2, 256, 256, 25, 5, 64, 100),
    (1, 77, 77, 5, 1, 16, None), (1, 150, 150, 5, 1, 16, 5),
    (2, 50, 130, 10, 2, 64, 20), (1, 100, 100, 4, 4, 16, None)])
def test_cuda_kernel_matches_plain_version(B, Sq, Skv, H, Hkv, D, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (q, k, v) = _inputs(B + Sq, B, Sq, Skv, H, Hkv, D, "bf16")
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    got = kernel.flash_attention(q, k, v, window=window)
    want = flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    # float32 sums in another order flip some bf16 roundings by one ulp:
    # each element within its own bound, few elements differing at all
    # (compare_bf16 gives the reasons)
    assert compare_bf16(got, want, q, k, v, window)["ok"]


def test_bench_cases_are_the_serving_slice_and_the_ragged_shapes():
    """The on-card driver's cases (``chip_smoke.py`` phase 9 runs the
    same): Hymba-1.5B's full and windowed layers of 4 x 4,096 tokens
    first, then ragged and D = 16 shapes; with the D = 128 cases of the
    Qwen3 models (``CASES_D128``) and the MLA cases of DeepSeek-V3
    (``CASES_MLA``: values narrower than keys) they cover every pair of
    head dims the kernel is built for; each bound is the tensor cores'
    time for the live pairs, above the time to move q, k, v and o."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import bench
    cfg = get_config("hymba-1.5b")
    cases = bench.cases(cfg)
    assert cases[:2] == [(4, 4096, 4096, 25, 5, 64, None),
                         (4, 4096, 4096, 25, 5, 64, cfg.sliding_window)]
    assert len(cases) == 6
    assert {(c[5], c[7] if len(c) > 7 else c[5]) for c in
            cases + bench.CASES_D128 + bench.CASES_MLA} == \
        set(kernel.HEAD_DIMS)
    assert any(c[1] < c[2] for c in cases)
    full, by = bench.bound_ms(*cases[0])
    assert by == "operations"
    assert full == pytest.approx(
        4 * 64 * 4 * 25 * live_pairs(4096, 4096) / bench.BF16_OPS_PER_S * 1e3)
    assert bench.bound_ms(*cases[1])[0] < full
    # the MUFU ceiling counts whole visited tiles: 64 * 65 / 2 of them for
    # each of the 100 (batch, head) pairs of the causal layer
    assert bench.ex2_ms(4, 4096, 4096, 25, None) == pytest.approx(
        100 * 2080 * 64 * 64 / bench.EX2_PER_S * 1e3)
