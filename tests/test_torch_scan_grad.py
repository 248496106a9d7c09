"""The gradient of the port's selective scan, on the CPU.

``kernels.selective_scan.selective_scan_bwd_ref`` (the plain version of
the backward kernel, and the backward ``SelectiveScanFn`` runs on the
CPU) is held against:

* ``jax.vjp`` of the reference's sequential oracle
  ``repro.kernels.selective_scan.ref.selective_scan_ref``, vmapped over
  the batch, with the same cotangents of ``y`` and ``h_T``;
* ``torch.autograd`` through the port's forward ``selective_scan_ref``;

at T a multiple of the 64-step chunk and not, ``Di % 4 != 0``, B = 1 and
2, ``h0`` and ``dh_T`` non-zero, and N = 8 besides the kernel's 16.
Tolerance: ``TOL`` = 1e-5 of each gradient's largest magnitude (the
forward's test holds the scan to 1e-5): all float32, the same formula,
with sums over time, channels and states in other orders.

Also: the states rebuilt from the sub-chunk starts are the forward's
bit for bit; the plain backward's sums in the kernel's written-out
orders; the reference's ``ssm_prefill`` gradients (every parameter and
the input, through ``jax.grad``) against the port's at the ``reduced``
Hymba config, to ``GRAD_RTOL`` = 2^-5 in relative L2 norm
(``tests/test_torch_train.py``'s tolerance: bf16 projections that round
an ulp apart); ``SelectiveScanFn``'s handling of absent cotangents,
inputs that need no gradient and activation checkpointing; and the
wrapper's refusal of CPU tensors.

One ``gpu``-marked test skips without a card: ``selective_scan_op``
under autograd on the card, whose backward is the hand-written kernel
(one launch a backward), against ``selective_scan_bwd_ref`` on the card.
This file imports JAX only inside the tests that use it, so that the
card's test runs where JAX is not installed (``python -m pytest
--noconftest -m gpu tests/test_torch_scan_grad.py``).
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.selective_scan import (bench, kernel,
                                                selective_scan_op,
                                                selective_scan_ref)
from repro_torch.kernels.selective_scan.ops import SelectiveScanFn
from repro_torch.kernels.selective_scan.ref import (BWD_CHANNELS,
                                                    CHUNK_STEPS, SUB_STEPS,
                                                    WARP_CHANNELS,
                                                    chunk_starts,
                                                    rebuild_states,
                                                    selective_scan_bwd_ref)

TOL = 1e-5
GRAD_RTOL = 2 ** -5
NAMES = ("du", "ddt", "dA", "dB", "dC", "dh0")

# (B, T, Di, N, h0 and dh_T non-zero)
CASES = {
    "t-chunks": (2, 2 * CHUNK_STEPS, 24, 16, True),
    "t-ragged-di-odd": (1, CHUNK_STEPS + 7, 37, 16, True),
    "t-short-zero-h": (2, 9, 8, 16, False),
    "n8": (2, 20, 6, 8, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, Di, N, nonzero=True):
    """Seeded float32 (u, dt, A, B, C, h0, dy, dh_T) as numpy arrays (h0
    zero and dh_T None unless ``nonzero``)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.normal(size=(B, T, Di)).astype(f),
           rng.uniform(0.001, 0.1, (B, T, Di)).astype(f),
           -rng.uniform(0.5, 2.0, (Di, N)).astype(f),
           rng.normal(size=(B, T, N)).astype(f),
           rng.normal(size=(B, T, N)).astype(f),
           rng.normal(size=(B, Di, N)).astype(f)]
    dy = rng.normal(size=(B, T, Di)).astype(f)
    dh_T = rng.normal(size=(B, Di, N)).astype(f)
    if not nonzero:
        out[5][:] = 0
        dh_T = None
    return out + [dy, dh_T]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(got, want, label):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (label, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case):
    import jax
    import jax.numpy as jnp
    from repro.kernels.selective_scan.ref import \
        selective_scan_ref as jax_ref
    B, T, Di, N, nonzero = CASES[case]
    arrays = _inputs(T + Di, B, T, Di, N, nonzero)
    *args, dy, dh_T = arrays
    got = selective_scan_bwd_ref(*_torch(arrays))
    # A is shared by the batch rows, so its cotangent sums over them
    ys, vjp = jax.vjp(jax.vmap(jax_ref, in_axes=(0, 0, None, 0, 0, 0)),
                      *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(ys[1]) if dh_T is None
                else jnp.asarray(dh_T)))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"{case} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_the_forward(case):
    B, T, Di, N, nonzero = CASES[case]
    *args, dy, dh_T = _torch(_inputs(T + Di + 1, B, T, Di, N, nonzero))
    got = selective_scan_bwd_ref(*args, dy, dh_T)
    leaves = [a.clone().requires_grad_() for a in args]
    y, h = selective_scan_ref(*leaves)
    loss = (y * dy).sum() + ((h * dh_T).sum() if dh_T is not None else 0)
    want = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"{case} {name}")


def test_rebuilt_states_replay_the_forward_bitwise():
    """Every state rebuilt from the sub-chunk starts (the state before
    every ``SUB_STEPS``-th step) equals the forward's ``h_T`` of that
    prefix bit for bit, and so does every sub-chunk start."""
    B, T, Di, N = 2, 2 * CHUNK_STEPS + 5, 5, 16
    u, dt, A, Bc, Cc, h0 = _torch(_inputs(3, B, T, Di, N))[:6]
    states = [h0] + [selective_scan_ref(u[:, :t], dt[:, :t], A, Bc[:, :t],
                                        Cc[:, :t], h0)[1]
                     for t in range(1, T + 1)]
    starts = chunk_starts(u, dt, A, Bc, h0)
    assert len(starts) == -(-T // SUB_STEPS)
    for k, h in enumerate(starts):
        t0 = k * SUB_STEPS
        assert torch.equal(h.view(torch.int32),
                           states[t0].view(torch.int32)), k
        hs, das = rebuild_states(u, dt, A, Bc, h, t0,
                                 min(t0 + SUB_STEPS, T))
        assert len(hs) == len(das) + 1
        for i, s in enumerate(hs):
            assert torch.equal(s.view(torch.int32),
                               states[t0 + i].view(torch.int32)), (k, i)


# (B, T, Di): a whole block and part of one, and Di one past a multiple
# of the block width with T % CHUNK_STEPS != 0
ORDER_CASES = {"two-blocks": (2, 3, 70),
               "width-boundary": (2, CHUNK_STEPS + 3, 33 * BWD_CHANNELS + 1)}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_plain_backward_sums_in_the_kernels_order(case):
    """dB and dC sum each warp's 8 channels as a balanced tree, then the
    warps of each ``BWD_CHANNELS``-wide block left to right, then the
    blocks left to right (zeros past Di); dA sums over time from the
    last step, then over batch rows: the same bits as those orders
    written out, and not the bits of a plain left-to-right sum over all
    channels (the inputs tell the orders apart)."""
    B, T, Di = ORDER_CASES[case]
    N = 16
    *args, dy, _ = _torch(_inputs(5, B, T, Di, N))
    u, dt, A, Bc, Cc, h0 = args
    _, _, dA, dB, dC, _ = selective_scan_bwd_ref(*args, dy)
    # the terms, from the rebuilt states and the same carries
    hs, das = rebuild_states(u, dt, A, Bc, h0, 0, T)
    carry = torch.zeros_like(h0)
    terms_b, terms_c, acc = [None] * T, [None] * T, torch.zeros_like(h0)
    for t in reversed(range(T)):
        g = dy[:, t, :, None] * Cc[:, t, None, :] + carry
        carry = das[t] * g
        acc = acc + dt[:, t, :, None] * (carry * hs[t])
        terms_b[t] = g * (dt[:, t] * u[:, t])[..., None]
        terms_c[t] = dy[:, t, :, None] * hs[t + 1]
    for terms, got in ((terms_b, dB), (terms_c, dC)):
        x = torch.stack(terms, 1)                     # [B, T, Di, N]
        zero = torch.zeros_like(x[:, :, 0])
        blocks = []
        for lo in range(0, Di, BWD_CHANNELS):
            warps = []
            for w in range(lo, lo + BWD_CHANNELS, WARP_CHANNELS):
                c = [x[:, :, d] if d < Di else zero
                     for d in range(w, w + WARP_CHANNELS)]
                warps.append(((c[0] + c[1]) + (c[2] + c[3]))
                             + ((c[4] + c[5]) + (c[6] + c[7])))
            part = warps[0]
            for p in warps[1:]:
                part = part + p
            blocks.append(part)
        want = blocks[0]
        for p in blocks[1:]:
            want = want + p
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        flat = x[:, :, 0]
        for d in range(1, Di):
            flat = flat + x[:, :, d]
        assert not torch.equal(got.view(torch.int32), flat.view(torch.int32))
    assert torch.equal(dA.view(torch.int32), (acc[0] + acc[1])
                       .view(torch.int32))


def test_ssm_prefill_gradients_match_the_reference():
    """Every parameter's and the input's gradient of ``ssm_prefill`` (a
    sum of its output and its state against seeded cotangents) at the
    reduced Hymba config, S = 40 with the reference's 16-step chunks (two
    full chunks and a padded one)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models.common import init_params as jax_init_params
    from repro.models.ssm import ssm_prefill as jax_ssm_prefill
    from repro.models.ssm import ssm_specs as jax_ssm_specs
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.ssm import ssm_prefill
    cfg = reduced(get_config("hymba-1.5b"))
    jcfg = jax_reduced(jax_get_config("hymba-1.5b"))
    jp = jax_init_params(jax_ssm_specs(jcfg), jax.random.PRNGKey(5))
    # each leaf in its dtype (bf16 values are exact in float32)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    S = 40
    assert S % jcfg.ssm_chunk
    rng = np.random.default_rng(6)
    di = cfg.ssm_expand * cfg.d_model
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    w_out = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    w_h = rng.normal(size=(2, di, cfg.ssm_state)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def jax_loss(jp, jx):
        out, (_, h) = jax_ssm_prefill(jp, jx, jcfg, jcfg.ssm_chunk)
        return (out.astype(jnp.float32) * w_out).sum() + (h * w_h).sum()
    want_p, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jp, jx)

    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(np.array(jx, np.float32)).bfloat16() \
        .requires_grad_()
    out, (_, h) = ssm_prefill(leaves, tx, cfg)
    loss = (out.float() * torch.from_numpy(w_out)).sum() + \
        (h * torch.from_numpy(w_h)).sum()
    names = sorted(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    for name, g, w in zip(names + ["x"], got,
                          [want_p[k] for k in names] + [want_x]):
        w = np.asarray(w, np.float32)
        rel = np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w)
        assert rel <= GRAD_RTOL, (name, rel)


def test_absent_cotangents_and_unneeded_inputs():
    """A gradient of ``y`` alone equals one with ``dh_T`` zeros; inputs
    that need no gradient get None; one of ``h_T`` alone takes dy as
    zeros."""
    B, T, Di, N = 1, 12, 6, 16
    *args, dy, dh_T = _torch(_inputs(7, B, T, Di, N))
    leaves = [a.clone().requires_grad_(i in (0, 2)) for i, a in
              enumerate(args)]
    y, h = SelectiveScanFn.apply(*leaves)
    got = torch.autograd.grad((y * dy).sum(), [leaves[0], leaves[2]])
    want = selective_scan_bwd_ref(*args, dy, torch.zeros_like(dh_T))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[2])
    y, h = SelectiveScanFn.apply(*leaves)
    got = torch.autograd.grad((h * dh_T).sum(), [leaves[0]])
    want = selective_scan_bwd_ref(*args, torch.zeros_like(dy), dh_T)
    assert torch.equal(got[0], want[0])
    # the backward's result for an input that needs none is None
    ctx = type("Ctx", (), {})()
    ctx.saved_tensors = tuple(args)
    ctx.needs_input_grad = (True, False, False, False, False, True)
    grads = SelectiveScanFn.backward(ctx, dy, None)
    assert grads[1:5] == (None,) * 4
    want = selective_scan_bwd_ref(*args, dy)
    assert torch.equal(grads[0], want[0]) and torch.equal(grads[5], want[5])


def test_op_gradient_under_checkpoint_is_the_same():
    """``torch.utils.checkpoint`` (the blocks' ``remat="full"``) runs the
    forward twice and gives the same gradients bit for bit."""
    B, T, Di, N = 2, 70, 9, 16
    *args, dy, dh_T = _torch(_inputs(8, B, T, Di, N))
    grads = []
    for remat in (False, True):
        leaves = [a.clone().requires_grad_() for a in args]

        def f(*xs):
            y, h = selective_scan_op(*xs)
            return (y * dy).sum() + (h * dh_T).sum()
        loss = checkpoint(f, *leaves, use_reentrant=False) if remat \
            else f(*leaves)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_backward_wrapper_refuses_cpu_tensors():
    args = _torch(_inputs(0, 1, 8, 16, 16))
    before = kernel.launch_counts()["selective_scan_bwd"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.selective_scan_bwd(*args)
    with pytest.raises(ValueError, match="dy"):
        selective_scan_bwd_ref(*args[:6], args[6][:, :4], None)
    assert kernel.launch_counts()["selective_scan_bwd"] == before


def test_backward_bound_and_cases():
    """The bound's terms at Hymba's training shape, and the bench's
    cases: both training shapes, T % 64 != 0, Di not a multiple of the
    block width and Di % 4 != 0, h0 and dh_T non-zero, T = 1, and Di one
    past a multiple of the block width."""
    b, t, di, n = 2, 4096, 3200, 16
    got = bench.scan_bwd_bound_ms(b, t, di, n)
    elems = b * t * di * n
    assert got["ex2_ms"] == pytest.approx(2 * elems / (16 * 132 * 1.98e9)
                                          * 1e3, rel=1e-12)
    assert got["fp32_ms"] == pytest.approx(18 * elems / 67e12 * 1e3,
                                           rel=1e-12)
    n_bytes = 4 * (5 * b * t * di + 2 * di * n + 4 * b * t * n
                   + 3 * b * di * n)
    assert got["bytes_ms"] == pytest.approx(n_bytes / 3.35e12 * 1e3,
                                            rel=1e-12)
    assert (got["limit"], got["bound_by"]) == ("MUFU ex2", "operations")
    cases = bench.BWD_CASES
    assert [c[:3] for c in cases[:2]] == list(bench.BWD_TRAIN)
    assert cases[2] == (1, 1000, 4100, True)     # chip_smoke.py's third
    assert any(c[1] % CHUNK_STEPS and c[2] % BWD_CHANNELS and c[2] % 4
               and c[3] for c in cases)
    assert any(c[1] == 1 for c in cases)
    assert any(c[2] % BWD_CHANNELS == 1 and c[2] > BWD_CHANNELS
               for c in cases)


@pytest.mark.gpu
def test_card_scan_gradient_is_the_kernel():
    """On the card ``selective_scan_op`` under autograd launches the
    forward kernel once and the backward kernel once, and its gradients
    equal ``selective_scan_bwd_ref``'s on the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for B, T, Di, N, nonzero in CASES.values():
        if N != kernel.STATE:
            continue
        *args, dy, dh_T = [None if a is None else a.cuda() for a in
                           _torch(_inputs(T + Di, B, T, Di, N, nonzero))]
        leaves = [a.clone().requires_grad_() for a in args]
        kernel.reset_launch_counts()
        y, h = selective_scan_op(*leaves)
        loss = (y * dy).sum() + ((h * dh_T).sum() if dh_T is not None
                                 else 0)
        got = torch.autograd.grad(loss, leaves)
        assert kernel.launch_counts() == {"selective_scan": 1,
                                          "selective_scan_bwd": 1}
        want = selective_scan_bwd_ref(*args, dy, dh_T)
        torch.cuda.synchronize()
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                name
