"""The port's Fat-Tree constructor against the reference's.

Same arguments -> identical ``nbrs``, ``nbr_port``, ``is_leaf``,
``level``, endpoint counts, name and ``meta``: full trees, a depopulated
one, and the paper's 104,976-endpoint ``fat_tree(36, 3, a1=18)`` of
Figure 6 (23,328 switches).  Tolerance: zero.
"""
import numpy as np
import pytest

import repro.api as jax_api
import repro.core as jax_core
import repro_torch.api as port_api
import repro_torch.core as port_core

ARGS = [(4, 2, None), (6, 2, None), (8, 3, 4), (12, 3, 6), (36, 3, 18)]


@pytest.mark.parametrize("radix,h,a1", ARGS)
def test_fat_tree_matches_reference(radix, h, a1):
    ref = jax_core.fat_tree(radix, h, a1=a1)
    port = port_core.fat_tree(radix, h, a1=a1)
    for field in ("nbrs", "nbr_port", "is_leaf", "level"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
        assert getattr(port, field).dtype == getattr(ref, field).dtype
    assert (port.name, port.kind, port.meta) == (ref.name, ref.kind,
                                                 ref.meta)
    assert port.n_endpoints == ref.n_endpoints
    assert port.endpoints_per_leaf == ref.endpoints_per_leaf
    np.testing.assert_array_equal(port.leaf_ids, ref.leaf_ids)


def test_fat_tree_through_the_spec_layer():
    spec = {"family": "fat_tree", "params": {"radix": 8, "h": 3, "a1": 4}}
    port = port_api.build_network(port_api.NetworkSpec.from_dict(spec))
    ref = jax_api.build_network(jax_api.NetworkSpec.from_dict(spec))
    np.testing.assert_array_equal(port.nbrs, ref.nbrs)
    assert "fat_tree" in port_api.topology_families()


def test_odd_radix_raises_like_reference():
    for mod in (jax_core, port_core):
        with pytest.raises(ValueError, match="even"):
            mod.fat_tree(5, 2)
