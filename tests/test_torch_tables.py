"""The port's topology and routing tables against the reference's.

Same constructor arguments and seed -> identical ``nbrs``/``nbr_port``,
identical int16 leaf distances, and identical packed port masks, block
by block, in both the dense and the blocked layout.  Fabrics: the
engine-parity golden ``mrls(14, 3, 3, seed=0)``, the Figure-5 scaled
``mrls(62, 6, 6, seed=1)`` and the paper's 11k-endpoint
``mrls(614, 18, 18, seed=1)``.  Tolerance: zero.
"""
import numpy as np
import pytest

import repro.core as jax_core
import repro_torch.core as port_core

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
    got_t = port_core.build_tables(port, masks=layout, leaf_block=block)
    assert got_t.mask_layout == want_t.mask_layout == layout
    np.testing.assert_array_equal(got_t.dist_leaf, want_t.dist_leaf)
    np.testing.assert_array_equal(got_t.leaf_rank, want_t.leaf_rank)
    n_blocks = 0
    for want, got in zip(want_t.mask_blocks(), got_t.mask_blocks(),
                         strict=True):
        assert got[:2] == want[:2]
        for w, g in zip(want[2:], got[2:]):
            assert g.dtype == w.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
        n_blocks += 1
    assert n_blocks == -(-ref.n_leaves // block)


def test_unbuildable_mrls_raises_like_reference():
    for mod in (jax_core, port_core):
        with pytest.raises(ValueError, match="divisible"):
            mod.mrls(n_leaves=5, u=3, d=4)
    with pytest.raises(ValueError, match="mask layout"):
        port_core.build_tables(port_core.mrls(14, 3, 3), masks="sparse")
