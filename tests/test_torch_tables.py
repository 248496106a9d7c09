"""The port's topology and routing tables against the reference's.

Same constructor arguments and seed -> identical ``nbrs``/``nbr_port``,
identical int16 leaf distances, and identical packed port masks: the
simulator's words, packed on its device from the distances in blocks of
leaf rows, and the host packing ``_pack_mask_block`` they are checked
against on the card, each against the reference's ``mask_blocks()`` in
its dense and its blocked layout.  Fabrics: the
engine-parity golden ``mrls(14, 3, 3, seed=0)``, the Figure-5 scaled
``mrls(62, 6, 6, seed=1)`` and the paper's 11k-endpoint
``mrls(614, 18, 18, seed=1)``.  Tolerance: zero.
"""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro_torch.core.routing import _pack_mask_block
from repro_torch.simulator.engine import SimConfig, Simulator

FABRICS = {
    "golden": dict(n_leaves=14, u=3, d=3, seed=0),
    "fig5_u6": dict(n_leaves=62, u=6, d=6, seed=1),
    "fig5_u18": dict(n_leaves=614, u=18, d=18, seed=1),
}


@pytest.fixture(scope="module", params=sorted(FABRICS))
def both(request):
    kw = FABRICS[request.param]
    return jax_core.mrls(**kw), port_core.mrls(**kw)


def test_mrls_matches_reference(both):
    ref, port = both
    for field in ("nbrs", "nbr_port", "is_leaf", "level"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
        assert getattr(port, field).dtype == getattr(ref, field).dtype
    assert port.endpoints_per_leaf == ref.endpoints_per_leaf
    assert port.name == ref.name and port.meta == ref.meta
    np.testing.assert_array_equal(port.leaf_ids, ref.leaf_ids)
    np.testing.assert_array_equal(port.leaf_rank(), ref.leaf_rank())


def test_leaf_distances_match_reference(both):
    ref, port = both
    want = jax_core.bfs_distances(ref, ref.leaf_ids)
    got = port_core.bfs_distances(port, port.leaf_ids)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout,block", [("dense", 256), ("blocked", 256),
                                          ("blocked", 100)])
def test_mask_blocks_match_reference(both, layout, block):
    ref, port = both
    want_t = jax_core.build_tables(ref, masks=layout, leaf_block=block)
    got_t = port_core.build_tables(port, leaf_block=block, device="cpu")
    assert want_t.mask_layout == layout and got_t.leaf_block == block
    assert got_t.dist_leaf.dtype == torch.int16
    np.testing.assert_array_equal(got_t.dist_leaf.numpy(), want_t.dist_leaf)
    np.testing.assert_array_equal(got_t.leaf_rank, want_t.leaf_rank)
    sim = Simulator(got_t, SimConfig(policy="polarized"), device="cpu")
    n, w = port.n_switches, sim.W
    dist = got_t.dist_leaf.numpy()
    valid = port.nbrs >= 0
    nbr_safe = np.where(valid, port.nbrs, 0)
    n_blocks = 0
    for lo, hi, want_min, want_away in want_t.mask_blocks():
        host = _pack_mask_block(dist[lo:hi], port.nbrs, valid, nbr_safe)
        for want, got, dev in ((want_min, host[0], sim.min_mask),
                               (want_away, host[1], sim.away_mask)):
            assert got.dtype == want.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                dev[lo * n:hi * n].numpy(),
                want.reshape(-1, w).view(np.int32))
        n_blocks += 1
    assert n_blocks == -(-ref.n_leaves // block)


def test_unbuildable_mrls_raises_like_reference():
    for mod in (jax_core, port_core):
        with pytest.raises(ValueError, match="divisible"):
            mod.mrls(n_leaves=5, u=3, d=4)
