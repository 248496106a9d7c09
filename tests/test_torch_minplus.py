"""The port's min-plus product against the reference's Pallas kernel.

``minplus_ref`` is held to the TPU kernel run in interpret mode (not to
the reference's pure-jnp oracle, which does not cap at ``INF``), at the
shapes of ``tests/test_kernels.py``, at ragged shapes and on inputs that
are mostly ``INF``.  ``adjacency_matrix`` and ``all_pairs_distances``
are held to the reference's, and the min-plus fixpoint's leaf rows to
the BFS tables, on small MRLS and Fat-Tree fabrics (N <= 256, because
interpret mode is slow).  Tolerance: zero.  The CUDA kernel against its
plain version runs only on a host with a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.kernels.minplus.kernel import minplus as jax_minplus
from repro.kernels.minplus.ops import \
    all_pairs_distances as jax_all_pairs_distances
from repro.kernels.minplus.ref import adjacency_matrix as jax_adjacency
from repro_torch.core.routing import minplus_distances
from repro_torch.kernels.minplus import (INF, adjacency_matrix,
                                         all_pairs_distances, all_pairs_ref,
                                         kernel, minplus_op, minplus_powers,
                                         minplus_ref)

FABRICS = {
    "mrls_golden": lambda m: m.mrls(14, 3, 3, seed=0),
    "ft_6_2": lambda m: m.fat_tree(6, 2),
    "ft_8_3_a4": lambda m: m.fat_tree(8, 3, a1=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, m, k, n, inf_frac=0.0):
    """Seeded float32 operands; ``inf_frac`` of the entries are INF."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    a[rng.random((m, k)) < inf_frac] = INF
    b[rng.random((k, n)) < inf_frac] = INF
    return a, b


@pytest.mark.parametrize("m,k,n,bm,bn,bk,inf_frac", [
    (64, 64, 64, 32, 32, 32, 0.0),
    (100, 70, 130, 32, 128, 32, 0.0),      # ragged -> padding path
    (128, 256, 128, 128, 128, 128, 0.0),
    (8, 8, 8, 32, 32, 32, 0.0),            # smaller than one block
    (37, 53, 29, 32, 32, 32, 0.0),
    (37, 53, 29, 32, 32, 32, 0.9),         # mostly INF: the cap
    (64, 40, 48, 32, 128, 32, 1.0),        # all INF: 2 * INF capped
])
def test_minplus_ref_matches_tpu_kernel(m, k, n, bm, bn, bk, inf_frac):
    a, b = _inputs(m * 1000 + n, m, k, n, inf_frac)
    want = np.asarray(jax_minplus(jnp.asarray(a), jnp.asarray(b), bm=bm,
                                  bn=bn, bk=bk, interpret=True))
    got = minplus_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if inf_frac:
        assert (want == np.float32(INF)).any()
    # the op dispatches a CPU tensor to the plain version
    np.testing.assert_array_equal(
        minplus_op(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)


def test_minplus_ref_reduces_k_in_chunks(monkeypatch):
    """Chunks of K that do not divide K give the same bits as one chunk."""
    import repro_torch.kernels.minplus.ref as ref_mod
    a, b = (torch.from_numpy(x) for x in _inputs(5, 30, 101, 20, 0.3))
    whole = minplus_ref(a, b)
    monkeypatch.setattr(ref_mod, "_CHUNK_ELEMS", 30 * 20 * 7)
    np.testing.assert_array_equal(minplus_ref(a, b).numpy(), whole.numpy())
    with pytest.raises(ValueError, match="inner sizes"):
        minplus_ref(a, b[:5])


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_adjacency_matrix_matches_reference(fabric):
    topo = FABRICS[fabric](port_core)
    want = np.asarray(jax_adjacency(FABRICS[fabric](jax_core).nbrs))
    got = adjacency_matrix(topo.nbrs, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_all_pairs_distances_match_reference_and_bfs(fabric):
    topo = FABRICS[fabric](port_core)
    assert topo.n_switches <= 256
    want = np.asarray(jax_all_pairs_distances(
        FABRICS[fabric](jax_core).nbrs, interpret=True))
    got = all_pairs_distances(topo.nbrs, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        all_pairs_ref(adjacency_matrix(topo.nbrs, device="cpu")).numpy(),
        want)
    # the fixpoint of the table build, mapped as the BFS marks distances
    d, squarings = minplus_distances(topo, torch.device("cpu"))
    np.testing.assert_array_equal(d.numpy(), want)
    bfs = port_core.bfs_distances(topo, topo.leaf_ids)
    np.testing.assert_array_equal(
        d[torch.as_tensor(topo.leaf_ids).long()].to(torch.int16).numpy(),
        bfs)
    # j squarings cover paths of up to 2**j hops; the build squares until
    # the diameter is covered, then once more to find nothing changed
    diameter = int(port_core.bfs_distances(
        topo, np.arange(topo.n_switches)).max())
    assert 2 ** (squarings - 2) < diameter <= 2 ** (squarings - 1)


def test_minplus_powers_counts_its_squarings():
    """A fixed ``n_iters`` squares that often, past the fixpoint too; with
    none the driver stops at the first squaring that changes nothing."""
    adj = adjacency_matrix(port_core.mrls(14, 3, 3, seed=0).nbrs,
                           device="cpu")
    fix, squarings = minplus_powers(adj)
    assert 2 <= squarings < 16
    more, n = minplus_powers(adj, minplus_op, n_iters=squarings + 2)
    assert n == squarings + 2
    np.testing.assert_array_equal(more.numpy(), fix.numpy())
    fewer, n = minplus_powers(adj, n_iters=1)
    assert n == 1 and not torch.equal(fewer, fix)


def test_unreachable_pairs_stay_at_inf():
    """Two disconnected pairs: the fixpoint keeps INF between them."""
    nbrs = np.array([[1], [0], [3], [2]], np.int32)
    d = all_pairs_ref(adjacency_matrix(nbrs, device="cpu"))
    assert d[0, 1] == 1 and d[0, 2] == np.float32(INF)


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros((4, 4))
    before = kernel.launch_counts()["minplus"]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.minplus(a, a)
    minplus_op(a, a)
    assert kernel.launch_counts()["minplus"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,inf_frac", [
    (37, 53, 29, 0.0), (37, 53, 29, 0.9), (64, 64, 64, 0.5),
    (130, 17, 257, 0.2), (1, 1, 1, 0.0)])
def test_cuda_kernel_matches_plain_version(m, k, n, inf_frac):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = (torch.from_numpy(x).cuda()
            for x in _inputs(m + k + n, m, k, n, inf_frac))
    got = kernel.minplus(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, minplus_ref(a, b), rtol=0, atol=0)
