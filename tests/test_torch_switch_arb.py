"""The port's switch_arb plain versions against the reference's, bitwise.

The same seeded numpy inputs go through ``repro.kernels.switch_arb.ref``
(jnp) and ``repro_torch.kernels.switch_arb.ref`` (torch, CPU); outputs
must be equal (tolerance zero: integer outputs of integer/float32
arithmetic with one rounding).  Shapes: the reference's kernel-test
cases plus the paper's 11k-endpoint fabric (N=921, R=54, P=36, V=4).
The CUDA kernels themselves are held to the plain versions by the
``gpu``-marked test, which runs only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.switch_arb import ops as jax_ops
from repro.kernels.switch_arb import ref as jax_ref
from repro_torch.kernels.switch_arb import kernel, ops, ref

ARB_SHAPES = [(8, 18, 12), (5, 9, 7), (16, 8, 128), (3, 33, 40),
              (921, 54, 36)]
VC_SHAPES = [(8, 12, 4), (5, 7, 3), (9, 16, 8), (921, 36, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small tensor ops: one intra-op thread is as fast and
    leaves the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arb_case(rng, n, r, p, tie_levels=None):
    tie = rng.random((n, r, p), dtype=np.float32)
    if tie_levels:   # coarse tiebreaks: many exactly equal scores
        tie = np.floor(tie * tie_levels).astype(np.float32) / tie_levels
    return (rng.integers(0, 12, (n, r, p), dtype=np.int32),
            rng.integers(0, 2, (n, r, p), dtype=np.int32),
            rng.integers(0, 2, (n, r, p), dtype=np.int32),
            tie,
            rng.integers(0, 2, (n, r), dtype=np.int32),
            rng.integers(0, 256, (n, r), dtype=np.int32),
            np.arange(n * r, dtype=np.int32).reshape(n, r))


def _vc_case(rng, n, p, v, levels=None):
    rand = rng.random((n, p, v), dtype=np.float32)
    if levels:
        rand = np.floor(rand * levels).astype(np.float32) / levels
    return rng.integers(0, 3, (n, p, v), dtype=np.int32), rand


def _both_arb(args, penalty=8.0):
    want = jax_ref.switch_arbitrate_ref(*map(jnp.asarray, args),
                                        penalty=penalty)
    got = ref.switch_arbitrate_ref(*map(torch.as_tensor, args),
                                   penalty=penalty)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("n,r,p", ARB_SHAPES, ids=str)
def test_arbitrate_plain_matches_reference(n, r, p):
    args = _arb_case(np.random.default_rng(n * 1000 + r), n, r, p)
    want, got = _both_arb(args)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("penalty", [0.0, 1.5, 8.0])
def test_arbitrate_ties_resolve_to_lowest_port(penalty):
    # four tie levels make equal scores common: argmin must pick the
    # lowest port, as jnp.argmin does
    args = _arb_case(np.random.default_rng(17), 12, 20, 10, tie_levels=4)
    want, got = _both_arb(args, penalty)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,p,v", VC_SHAPES, ids=str)
@pytest.mark.parametrize("levels", [None, 2])
def test_vc_prearb_plain_matches_reference(n, p, v, levels):
    qlen, rand = _vc_case(np.random.default_rng(n), n, p, v, levels)
    want = jax_ref.vc_prearb_ref(jnp.asarray(qlen), jnp.asarray(rand))
    got = ref.vc_prearb_ref(torch.as_tensor(qlen), torch.as_tensor(rand))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_arbitrate_grants_unique_per_output_port():
    args = _arb_case(np.random.default_rng(7), 6, 20, 10)
    port, win, seg = ref.switch_arbitrate_ref(*map(torch.as_tensor, args),
                                              penalty=8.0)
    port, win, seg = port.numpy(), win.numpy().astype(bool), seg.numpy()
    for n in range(6):
        granted = port[n][win[n]]
        assert len(granted) == len(set(granted.tolist())), \
            "two grants on one output port"
        # seg is -1 exactly on ports with no grant
        assert set(np.nonzero(seg[n] >= 0)[0]) == set(granted.tolist())


def test_flat_adapter_matches_reference():
    # 3 switches, r_max 4, two dense rows left unoccupied
    rng = np.random.default_rng(11)
    n, r_max, p = 3, 4, 5
    row_of = np.array([0, 1, 2, 4, 5, 6, 8, 9, 3, 7], np.int32)
    nr = row_of.shape[0]
    args = (rng.integers(0, 5, (nr, p), dtype=np.int32),
            rng.integers(0, 2, (nr, p), dtype=np.int32),
            rng.integers(0, 2, (nr, p), dtype=np.int32),
            rng.random((nr, p), dtype=np.float32),
            rng.integers(0, 2, (nr,), dtype=np.int32),
            rng.integers(0, 256, (nr,), dtype=np.int32),
            np.arange(nr, dtype=np.int32))
    want = jax_ops.switch_arbitrate_flat(
        *map(jnp.asarray, args), penalty=8.0, row_of=jnp.asarray(row_of),
        n_switches=n, r_max=r_max, use_ref=True)
    got = ops.switch_arbitrate_flat(
        *map(torch.as_tensor, args), penalty=8.0,
        row_of=torch.as_tensor(row_of, dtype=torch.int64), n_switches=n,
        r_max=r_max)
    assert got[0].shape == (nr,) and got[2].shape == (n * p,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      np.asarray(w).astype(np.int32))


def test_cpu_tensors_take_the_plain_version():
    qlen, rand = _vc_case(np.random.default_rng(2), 4, 6, 4)
    q, r = torch.as_tensor(qlen), torch.as_tensor(rand)
    for g, w in zip(ops.vc_prearb(q, r), ref.vc_prearb_ref(q, r)):
        assert torch.equal(g, w)
    # the kernel wrapper itself takes CUDA tensors only: no fallback
    with pytest.raises(ValueError, match="CUDA"):
        kernel.vc_prearb(q, r)
    args = [torch.as_tensor(a) for a in
            _arb_case(np.random.default_rng(3), 2, 5, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.switch_arbitrate(*args, penalty=8.0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fig5", "ragged"])
def test_cuda_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    arb, vc = (((921, 54, 36),), ((921, 36, 4),)) if case == "fig5" else (
        ((5, 9, 7), (3, 300, 290)), ((5, 7, 3), (9, 16, 8)))
    for n, r, p in arb:
        args = [torch.as_tensor(a, device=dev) for a in
                _arb_case(np.random.default_rng(n + r), n, r, p)]
        got = kernel.switch_arbitrate(*args, penalty=8.0)
        want = ref.switch_arbitrate_ref(*args, penalty=8.0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for n, p, v in vc:
        args = [torch.as_tensor(a, device=dev) for a in
                _vc_case(np.random.default_rng(n + p), n, p, v)]
        for g, w in zip(kernel.vc_prearb(*args), ref.vc_prearb_ref(*args)):
            assert torch.equal(g, w)
    torch.cuda.synchronize()
