"""The int16 hop-count min-plus product and the table build that runs it.

``minplus_hops_ref`` (the plain version of the CUDA ``minplus_hops``
kernel, on Hopper's DPX instructions) is held, mapped to float32
(``v -> float(v)``, ``HOPS_INF -> INF``), to the float32 ``minplus_ref``
and to the reference's Pallas ``minplus`` in interpret mode, on the same
seeded integer operands: ragged and odd shapes, 1 x 1 x 1, and "no path"
shares 0 / 0.5 / 0.9 / 1.0.  The driver ``hop_distances`` (leaf rows
first in every squaring, stopped by the rule "largest finite entry below
2**k after k squarings") is held to the reference's ``build_tables`` and
the BFS on small fabrics, on path graphs whose diameters lie on either
side of a power of two, and on a disconnected graph, with the product
count the rule predicts.  Tolerance: zero.  The CUDA kernel against its
plain version runs only on a host with a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.core.topology as jax_topology
import repro_torch.core as port_core
import repro_torch.core.routing as routing
import repro_torch.core.topology as port_topology
import repro_torch.kernels.minplus.ref as ref_mod
from repro.kernels.minplus.kernel import minplus as jax_minplus
from repro_torch.core.routing import hop_distances
from repro_torch.kernels.minplus import (HOPS_INF, HOPS_LIMIT, INF,
                                         adjacency_matrix, hops_adjacency,
                                         kernel, minplus_hops_op,
                                         minplus_hops_ref, minplus_ref,
                                         padded_hops)

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


def _hops(seed, m, k, n, share):
    """Seeded hop counts below HOPS_LIMIT, ``share`` of them HOPS_INF:
    numpy ``a`` [M, K] and ``b`` [K, N]."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, HOPS_LIMIT, (m, k))
    b = rng.integers(0, HOPS_LIMIT, (k, n))
    a[rng.random((m, k)) < share] = HOPS_INF
    b[rng.random((k, n)) < share] = HOPS_INF
    return a.astype(np.int16), b.astype(np.int16)


def _as_float(x):
    """int16 hops -> the float32 form: HOPS_INF -> INF."""
    x = np.asarray(x)
    return np.where(x == HOPS_INF, np.float32(INF),
                    x.astype(np.float32)).astype(np.float32)


def _padded(x, device=None):
    """numpy int16 ``x`` in the kernel's padded row layout."""
    t = padded_hops(*x.shape, device=device)
    t.copy_(torch.from_numpy(np.ascontiguousarray(x)))
    return t


@pytest.mark.parametrize("m,k,n,bm,bn,bk,share", [
    (1, 1, 1, 32, 32, 32, 0.0),
    (37, 53, 29, 32, 32, 32, 0.0),
    (37, 53, 29, 32, 32, 32, 0.5),
    (37, 53, 29, 32, 32, 32, 0.9),
    (64, 40, 48, 32, 128, 32, 1.0),        # all "no path": S + S capped
    (100, 70, 130, 32, 128, 32, 0.0),      # ragged -> padding path
    (129, 131, 127, 128, 128, 128, 0.5),   # odd sizes
    (8, 8, 8, 32, 32, 32, 0.9),
])
def test_hops_ref_matches_float_ref_and_tpu_kernel(m, k, n, bm, bn, bk,
                                                   share):
    a, b = _hops(m * 1000 + n + k, m, k, n, share)
    af, bf = _as_float(a), _as_float(b)
    want = np.asarray(jax_minplus(jnp.asarray(af), jnp.asarray(bf), bm=bm,
                                  bn=bn, bk=bk, interpret=True))
    got = minplus_hops_ref(torch.from_numpy(np.ascontiguousarray(a.T)),
                           torch.from_numpy(b))
    assert got.dtype == torch.int16 and got.shape == (m, n)
    np.testing.assert_array_equal(_as_float(got.numpy()), want)
    np.testing.assert_array_equal(
        _as_float(got.numpy()),
        minplus_ref(torch.from_numpy(af), torch.from_numpy(bf)).numpy())
    if share == 1.0:
        assert (got == HOPS_INF).all()
    # the op dispatches CPU tensors to the plain version, padded or not,
    # into ``out`` when given
    np.testing.assert_array_equal(
        minplus_hops_op(_padded(a.T), _padded(b)).numpy(), got.numpy())
    out = padded_hops(m, n)
    assert minplus_hops_op(_padded(a.T), _padded(b), out=out) is out
    np.testing.assert_array_equal(out.numpy(), got.numpy())


def test_hops_ref_reduces_k_in_chunks(monkeypatch):
    """Chunks of K that do not divide K give the same bits as one chunk."""
    a, b = _hops(5, 30, 101, 20, 0.3)
    at, bt = torch.from_numpy(np.ascontiguousarray(a.T)), torch.from_numpy(b)
    whole = minplus_hops_ref(at, bt)
    monkeypatch.setattr(ref_mod, "_CHUNK_ELEMS", 30 * 20 * 7)
    np.testing.assert_array_equal(minplus_hops_ref(at, bt).numpy(),
                                  whole.numpy())
    with pytest.raises(ValueError, match="inner sizes"):
        minplus_hops_ref(at, bt[:5])


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_hops_adjacency_is_the_float_adjacency(fabric):
    topo = FABRICS[fabric](port_core)
    got = hops_adjacency(topo.nbrs, device="cpu")
    n = topo.n_switches
    assert got.dtype == torch.int16 and got.shape == (n, n)
    assert got.stride(0) % 8 == 0 and got.stride(0) >= n
    np.testing.assert_array_equal(
        _as_float(got.numpy()),
        adjacency_matrix(topo.nbrs, device="cpu").numpy())
    # the row padding holds "no path"
    base = got.as_strided((n, got.stride(0)), (got.stride(0), 1))
    assert (base[:, n:] == HOPS_INF).all()


def _predicted_products(ecc: int, n: int, n_rows: int) -> int:
    """Products the stopping rule takes: K squarings with ecc < 2**K, the
    last one only for the needed rows (rounded up to 8), each other one
    in two products unless those rows are every row."""
    squarings = ecc.bit_length()
    if squarings == 0:
        return 0
    per = 1 if min(-(-n_rows // 8) * 8, n) >= n else 2
    return per * (squarings - 1) + 1


def _check_driver(ref_topo, port_topo):
    """hop_distances on the CPU equals the reference's tables and the BFS,
    with the predicted number of products; returns that number."""
    want = jax_core.build_tables(ref_topo, full=True)
    bfs = port_core.bfs_distances(port_topo, np.arange(port_topo.n_switches))
    leaf, none, products = hop_distances(port_topo.nbrs, port_topo.leaf_ids,
                                         torch.device("cpu"))
    assert none is None and leaf.dtype == torch.int16
    np.testing.assert_array_equal(leaf.numpy(), want.dist_leaf)
    np.testing.assert_array_equal(leaf.numpy(), bfs[port_topo.leaf_ids])
    n = port_topo.n_switches
    ecc = int(bfs[port_topo.leaf_ids].max())
    assert products == _predicted_products(ecc, n, port_topo.n_leaves)
    leaf_f, full, products_f = hop_distances(
        port_topo.nbrs, port_topo.leaf_ids, torch.device("cpu"), full=True)
    np.testing.assert_array_equal(full.numpy(), want.dist_full)
    np.testing.assert_array_equal(full.numpy(), bfs)
    np.testing.assert_array_equal(leaf_f.numpy(), want.dist_leaf)
    assert products_f == _predicted_products(int(bfs.max()), n, n)
    return products


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_hop_distances_match_reference_and_bfs(fabric):
    products = _check_driver(FABRICS[fabric](jax_core),
                             FABRICS[fabric](port_core))
    assert products >= 3


def _path(module, length: int, extra: int = 0):
    """A path of ``length`` hops (diameter ``length``) and ``extra``
    isolated switches; leaves are the far end and the middle of the path
    (so the driver relabels them first) and one isolated switch."""
    n = length + 1 + extra
    edges = np.array([(i, i + 1) for i in range(length)], np.int64)
    is_leaf = np.zeros(n, bool)
    is_leaf[[length // 2, length]] = True
    if extra:
        is_leaf[length + 1] = True
    return module._from_edges(f"path{length}", "direct", n, edges, is_leaf,
                              1, np.zeros(n, np.int32), max_ports=2)


@pytest.mark.parametrize("extra", [0, 9])
@pytest.mark.parametrize("length", [3, 4, 5, 8, 9])
def test_hop_distances_on_path_graphs(length, extra):
    """Diameters on either side of a power of two: the rule stops at the
    first k with 2**k above the leaf rows' largest distance."""
    ref_topo = _path(jax_topology, length, extra)
    port_topo = _path(port_topology, length, extra)
    assert not np.array_equal(port_topo.leaf_ids,
                              np.arange(port_topo.n_leaves))
    products = _check_driver(ref_topo, port_topo)
    # the far end sees the whole path
    n = port_topo.n_switches
    assert products == _predicted_products(length, n, port_topo.n_leaves)


def test_hop_distances_on_a_disconnected_graph():
    """Two rings and an isolated switch: -1 between the parts, and the
    rule reads only finite entries."""
    edges = [(i, (i + 1) % 7) for i in range(7)] + \
        [(7 + i, 7 + (i + 1) % 5) for i in range(5)]
    n = 13
    is_leaf = np.zeros(n, bool)
    is_leaf[[0, 3, 8, 12]] = True

    def make(module):
        return module._from_edges("rings", "direct", n,
                                  np.array(edges, np.int64), is_leaf, 1,
                                  np.zeros(n, np.int32))
    products = _check_driver(make(jax_topology), make(port_topology))
    leaf, _, _ = hop_distances(make(port_topology).nbrs,
                               np.flatnonzero(is_leaf), torch.device("cpu"))
    # rows: switches 0, 3, 8, 12
    assert leaf[0, 8] == -1 and leaf[1, 0] == 3 and leaf[2, 11] == 2
    assert leaf[3, 12] == 0 and (leaf[3, :12] == -1).all()
    assert products == _predicted_products(3, n, 4)


def test_hop_distances_refuse_an_asymmetric_adjacency():
    nbrs = np.array([[1, -1], [2, -1], [1, -1]], np.int32)   # 0 -> 1 only
    with pytest.raises(ValueError, match="not symmetric"):
        hop_distances(nbrs, np.array([0]), torch.device("cpu"))


def test_hop_distances_refuse_distances_past_the_int16_range(monkeypatch):
    """The driver raises once a needed row holds a distance of
    ``HOPS_LIMIT`` or more, past which int16 sums could saturate.  At the
    real sentinel that needs a path of 8,193 switches; the same rule is
    held here with the sentinel set to 63 (limit 32) in every module that
    reads it, on paths of 31 and 32 hops."""
    assert HOPS_LIMIT == 8192 and 2 * (HOPS_LIMIT - 1) < HOPS_INF
    for mod in (ref_mod, routing):
        monkeypatch.setattr(mod, "HOPS_INF", 63)
        monkeypatch.setattr(mod, "HOPS_LIMIT", 32)
    ok = _path(port_topology, 31)
    leaf, _, products = hop_distances(ok.nbrs, ok.leaf_ids,
                                      torch.device("cpu"))
    assert int(leaf.max()) == 31
    assert products == _predicted_products(31, ok.n_switches, ok.n_leaves)
    far = _path(port_topology, 32)
    with pytest.raises(ValueError, match="reach 32 or more"):
        hop_distances(far.nbrs, far.leaf_ids, torch.device("cpu"))


@pytest.mark.parametrize("case", ["cpu", "dtype", "rows", "ld", "inner"])
def test_hops_wrapper_refuses_what_the_kernel_does_not_take(case):
    good = padded_hops(16, 16)
    at, b = {
        "cpu": (good, good),
        "dtype": (good.float(), good),
        "rows": (good.t(), good),                 # columns contiguous
        "ld": (torch.full((16, 12), 1, dtype=torch.int16), good),
        "inner": (padded_hops(15, 16), good),
    }[case]
    before = kernel.launch_counts()["minplus_hops"]
    with pytest.raises((ValueError, TypeError),
                       match={"cpu": "CUDA", "dtype": "dtype",
                              "rows": "not contiguous", "ld": "multiple of 8",
                              "inner": "inner sizes"}[case]):
        kernel.minplus_hops(at, b)
    assert kernel.launch_counts()["minplus_hops"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,share", [
    (1, 1, 1, 0.0), (37, 53, 29, 0.0), (37, 53, 29, 0.9), (64, 40, 48, 1.0),
    (129, 131, 127, 0.5), (130, 17, 257, 0.2)])
def test_cuda_hops_kernel_matches_plain_version(m, k, n, share):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _hops(m + k + n, m, k, n, share)
    at, bt = (_padded(x, device="cuda") for x in (a.T, b))
    got = kernel.minplus_hops(at, bt)
    torch.cuda.synchronize()
    assert torch.equal(got, minplus_hops_ref(at, bt))
