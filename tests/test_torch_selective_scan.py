"""The port's selective scan against the reference's.

``selective_scan_ref`` (the plain version of the CUDA kernel) is held to
the reference's Pallas kernel run in interpret mode and to its
sequential jnp oracle ``selective_scan_ref``, and the port's
``ssm_prefill`` (one scan over the prompt) to the reference's
``ssm_prefill`` (chunks of ``lax.associative_scan``) at a length that is
not a multiple of the chunk.  Tolerances, with reasons:

* the scans: all float32, the same recurrence; the sum over the state
  runs in another order and ``exp`` is another implementation, so
  values agree to 1e-5 relative and absolute (the reference's own
  kernel test uses the same);
* ``ssm_prefill``: the bf16 projections and the conv may round one ulp
  apart, so the bf16 output agrees to 2^-7 of its largest value and
  the float32 state to 1e-3 of its largest value; the conv state, taken
  straight from the bf16 input projection, to 2^-7 of its largest value.

The CUDA kernel against its plain version runs only on a host with a
card (marked ``gpu``), where it should be bitwise equal.  Here, without
a card, the kernel's order of the sum over the state (K states a lane,
registers first, then xor shuffles) is replayed in torch and held
bitwise to ``state_sum``, and the bench's bound and SASS counting are
checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.selective_scan.kernel import selective_scan as jax_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro.models.common import init_params as jax_init_params
from repro.models.model import build_specs as jax_build_specs
from repro.models.ssm import ssm_prefill as jax_ssm_prefill
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.selective_scan import (bench, kernel,
                                                selective_scan_op,
                                                selective_scan_ref, state_sum)
from repro_torch.models.ssm import ssm_prefill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, Di, N):
    """Seeded float32 u, dt, A, B, C, h0 as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, Di)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, T, Di)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (Di, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, T, N)).astype(np.float32),
            rng.normal(size=(B, Di, N)).astype(np.float32)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,T,Di,N,bd", [
    (2, 32, 64, 16, 32),
    (1, 50, 48, 16, 16),        # ragged T
    (3, 16, 32, 8, 32),
])
def test_plain_matches_pallas_kernel(B, T, Di, N, bd):
    args = _inputs(B * T + Di, B, T, Di, N)
    y, h = selective_scan_ref(*map(torch.from_numpy, args))
    yj, hj = jax_scan(*map(jnp.asarray, args), bd=bd, interpret=True)
    _close(y, yj, 1e-5)
    _close(h, hj, 1e-5)


@pytest.mark.parametrize("B,T,Di,N", [(2, 40, 24, 16), (1, 7, 5, 4)])
def test_plain_matches_sequential_oracle(B, T, Di, N):
    args = _inputs(T + Di, B, T, Di, N)
    y, h = selective_scan_ref(*map(torch.from_numpy, args))
    u, dt, A, Bc, Cc, h0 = map(jnp.asarray, args)
    for i in range(B):
        yr, hr = jax_ref(u[i], dt[i], A, Bc[i], Cc[i], h0[i])
        _close(y[i], yr, 1e-5)
        _close(h[i], hr, 1e-5)


@pytest.mark.parametrize("n", [16, 8, 6, 1])
def test_state_sum_is_the_halving_tree(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(3, n))
                         .astype(np.float32))
    want = x.clone()
    while want.shape[-1] % 2 == 0 and want.shape[-1] > 1:
        h = want.shape[-1] // 2
        want = torch.stack([want[:, i] + want[:, i + h] for i in range(h)],
                           dim=1)
    want = want.sum(-1) if want.shape[-1] <= 1 else \
        want[:, 0] + want[:, 1] + want[:, 2]
    assert torch.equal(state_sum(x), want)


def test_ssm_prefill_matches_the_chunked_reference():
    """S = 40 with chunks of 16: two full chunks and a padded one."""
    cfg = reduced(get_config("hymba-1.5b"))
    jcfg = jax_reduced(jax_get_config("hymba-1.5b"))
    np_params = jax.device_get(jax_init_params(jax_build_specs(jcfg),
                                               jax.random.PRNGKey(3)))
    p = params_from_jax(np_params, cfg, "cpu")["groups"]["h1"]["ssm"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["groups"]["h1"]["ssm"])
    p = {k: v[0] for k, v in p.items()}
    S = 40
    assert S % jcfg.ssm_chunk
    x = np.random.default_rng(4).normal(size=(2, S, cfg.d_model)) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want, (wconv, wh) = jax_ssm_prefill(jp, jx, jcfg, jcfg.ssm_chunk)
    got, (gconv, gh) = ssm_prefill(
        p, torch.from_numpy(np.array(jx, np.float32)).bfloat16(), cfg)
    want, wconv, wh = (np.asarray(a, np.float32) for a in (want, wconv, wh))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(gconv.float().numpy(), wconv, rtol=0,
                               atol=2 ** -7 * np.abs(wconv).max())
    np.testing.assert_allclose(gh.numpy(), wh, rtol=0,
                               atol=1e-3 * np.abs(wh).max())


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 8, 16, 16)]
    before = kernel.launch_counts()["selective_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.selective_scan(*args)
    selective_scan_op(*args)
    assert kernel.launch_counts()["selective_scan"] == before


def test_shapes_the_scan_does_not_take_raise():
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 8, 16, 16)]
    args[3] = args[3][:, :4]
    with pytest.raises(ValueError, match="Bc"):
        selective_scan_ref(*args)


def _lane_tree(v: torch.Tensor, k: int) -> list:
    """The kernel's sum over the state of ``v`` [..., 16], written out in
    torch: lane j of a channel's 16 / k lanes holds states j, j + L, ...
    (L = 16 / k); each lane adds registers w apart (w = k/2, ..., 1:
    state offsets 8, ..., L), then every lane adds its own value and its
    partner's at xor offsets L/2, ..., 1 (``__fadd_rn(y,
    __shfl_xor_sync(y, s))``).  Returns every lane's result."""
    lanes = 16 // k
    regs = [[v[..., j + i * lanes] for i in range(k)] for j in range(lanes)]
    w = k // 2
    while w >= 1:
        regs = [[r[i] + r[i + w] for i in range(w)] for r in regs]
        w //= 2
    y = [r[0] for r in regs]
    s = lanes // 2
    while s >= 1:
        y = [y[j] + y[j ^ s] for j in range(lanes)]
        s //= 2
    return y


def _sum_order_inputs(seed: int) -> torch.Tensor:
    """Seeded float32 [rows, 16] where the order of a sum shows: exact
    cancellations (v[n + 8] = -v[n] and v[n + 4] = -v[n]), mixed
    magnitudes, rows of +0 and -0, and plain normals."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    x[:8, 8:] = -x[:8, :8]
    x[8:16, 4:8] = -x[8:16, :4]
    x[16:24, ::3] *= np.float32(1e7)
    x[24:32] = rng.choice(np.array([0.0, -0.0], np.float32), size=(8, 16))
    x[32:40, 1::2] = -0.0
    x[32:40, ::2] = 0.0
    x[40:48] = np.float32(1.0)
    x[40:48, ::5] = np.float32(1e8)
    return torch.from_numpy(x)


@pytest.mark.parametrize("k", kernel.VARIANTS)
def test_lane_tree_equals_state_sum_bitwise(k):
    v = _sum_order_inputs(k)
    want = state_sum(v).view(torch.int32)
    for lane, got in enumerate(_lane_tree(v, k)):
        assert torch.equal(got.view(torch.int32), want), (k, lane)
    # the inputs tell orders apart: a left-to-right sum differs somewhere
    seq = v[:, 0].clone()
    for n in range(1, 16):
        seq = seq + v[:, n]
    assert not torch.equal(seq.view(torch.int32), want)


def test_scan_bound_terms_at_the_serving_slice():
    b, t, di, n = 4, 4096, 3200, 16
    elems = b * t * di * n
    got = bench.scan_bound_ms(b, t, di, n)
    n_bytes = 4 * (3 * b * t * di + di * n + 2 * b * t * n + 2 * b * di * n)
    assert got["bytes_ms"] == pytest.approx(n_bytes / 3.35e12 * 1e3,
                                            rel=1e-12)
    assert got["fp32_ms"] == pytest.approx(7 * elems / 67e12 * 1e3,
                                           rel=1e-12)
    assert got["ex2_ms"] == pytest.approx(elems / (16 * 132 * 1.98e9) * 1e3,
                                          rel=1e-12)
    assert round(got["ex2_ms"], 4) == 0.2006
    assert round(got["bytes_ms"], 3) == 0.189
    assert got["bound_ms"] == got["ex2_ms"]
    assert (got["limit"], got["bound_by"]) == ("MUFU ex2", "operations")


def test_bench_cases_cover_the_kernels_edges():
    """The serving slice first, then Di % 4 != 0, and T % CHUNK_STEPS != 0
    both with Di % 4 == 0 and not, and T below one staged run."""
    cs = bench.cases()
    tc = kernel.CHUNK_STEPS
    assert cs[0][:3] == bench.SERVE
    assert any(di % 4 for _, _, di, _ in cs)
    assert any(t % tc and not di % 4 for _, t, di, _ in cs)
    assert any(t % tc and di % 4 and t > tc for _, t, di, _ in cs)
    assert any(t < tc for _, t, _, _ in cs)


def test_sass_counts_reads_opcodes_with_modifiers(monkeypatch):
    sass = """
        Function : _ZN12_GLOBAL__N_121selective_scan_kernelILi4EEvPKfS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R5], desc[UR4][R6.64] ;
        /*0020*/                   LDS.128 R8, [R9] ;
        /*0030*/                   MUFU.EX2 R4, R4 ;
        /*0040*/                   MUFU.EX2 R5, R5 ;
        /*0050*/                   MUFU.RCP R6, R6 ;
        /*0060*/                   SHFL.BFLY PT, R3, R2, 0x2, 0x1f ;
        /*0070*/              @!P0 STS [R1], R3 ;
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R12 ;
        /*0090*/                   LDG.E R2, desc[UR4][R2.64] ;
        Function : _ZN5other_kernelEv
        /*0000*/                   SHFL.BFLY PT, R3, R2, 0x2, 0x1f ;
"""
    monkeypatch.setattr(bench, "_sass", lambda path: sass)
    got = bench.sass_counts("unused")
    assert list(got) == ["selective_scan_kernel<4>"]
    rec = got["selective_scan_kernel<4>"]
    assert {op: rec[op] for op in ("MUFU.EX2", "SHFL", "LDG", "LDGSTS",
                                   "LDS", "STS", "STG")} == {
        "MUFU.EX2": 2, "SHFL": 1, "LDG": 1, "LDGSTS": 1, "LDS": 1, "STS": 1,
        "STG": 1}
    assert rec["total"] == 10
    assert rec["shfl_per_channel_step"] == 8.0


def test_sass_counts_reads_the_backward_kernels(monkeypatch):
    """The backward's two kernels by name, ``BAR`` and the copy opcodes
    counted, and ``MUFU.EX2`` over the 8 × 4 state-steps of a walk's
    unrolled body."""
    body = "".join(f"        /*{i:04x}*/                   MUFU.EX2 R4, R4 ;\n"
                   for i in range(64))
    sass = f"""
        Function : _ZN12_GLOBAL__N_125selective_scan_bwd_kernelEPKfS1_
{body}        /*1000*/                   LDGSTS.E.128 [R5], desc[UR4][R6.64] ;
        /*1010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*1020*/                   SHFL.BFLY PT, R3, R2, 0x4, 0x1f ;
        /*1030*/                   LDG.E.128.STRONG.GPU R8, desc[UR4][R2.64] ;
        /*1040*/              @P0 STS [R1], R3 ;
        Function : _ZN12_GLOBAL__N_129selective_scan_bwd_sum_kernelEPKfS1_
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/                   STG.E desc[UR4][R2.64], R3 ;
"""
    monkeypatch.setattr(bench, "_sass", lambda path: sass)
    got = bench.sass_counts("unused")
    assert list(got) == ["selective_scan_bwd_kernel",
                         "selective_scan_bwd_sum_kernel"]
    rec = got["selective_scan_bwd_kernel"]
    assert {op: rec[op] for op in ("MUFU.EX2", "LDGSTS", "BAR", "SHFL",
                                   "LDG", "STS", "STG", "UTMALDG")} == {
        "MUFU.EX2": 64, "LDGSTS": 1, "BAR": 1, "SHFL": 1, "LDG": 1,
        "STS": 1, "STG": 0, "UTMALDG": 0}
    assert rec["ex2_per_state_step"] == 2.0
    assert rec["total"] == 69
    assert got["selective_scan_bwd_sum_kernel"]["LDG"] == 1
    assert "ex2_per_state_step" not in got["selective_scan_bwd_sum_kernel"]


def test_variant_wrapper_refuses_cpu_tensors_and_unknown_variants():
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 8, 16, 16)]
    before = kernel.launch_counts()["selective_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.selective_scan_variant(*args, 4)
    with pytest.raises(ValueError, match="k=3"):
        kernel.selective_scan_variant(*args, 3)
    with pytest.raises(ValueError, match="channels=6"):
        kernel.selective_scan_variant(*args, 4, 6)
    assert kernel.launch_counts()["selective_scan"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Di", [(2, 300, 3200), (1, 77, 50),
                                    (3, 1, 17), (1, 1000, 3211),
                                    (2, kernel.CHUNK_STEPS + 1, 50)])
def test_cuda_kernel_matches_plain_version(B, T, Di):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.from_numpy(a).cuda() for a in _inputs(B + T, B, T, Di, 16)]
    y, h = kernel.selective_scan(*args)
    yr, hr = selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, yr) and torch.equal(h, hr)
