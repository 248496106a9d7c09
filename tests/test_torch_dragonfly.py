"""The port's Dragonfly and Dragonfly+ against the reference's.

Same arguments -> identical ``nbrs``, ``nbr_port``, ``is_leaf``,
``level``, endpoint counts, name, kind and ``meta``, up to Figure 7's
``dragonfly(16, 8, 8)`` (2,064 switches, every one a leaf, P = 23) and
``dragonfly_plus(65, 16, 16, 16, 16)`` (1,040 leaves among 2,080
switches, P = 32, each leaf's last 16 ports unlinked).  On the small
fabrics the CPU table build (the host BFS) and the min-plus build
``hop_distances`` on the plain ``minplus_hops`` give the reference's
``dist_leaf``, the latter in the number of products its stopping rule
predicts.  The spec layer resolves both families.  Tolerance: zero.
"""
import numpy as np
import pytest
import torch

import repro.api as jax_api
import repro.core as jax_core
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro_torch.core.routing import hop_distances

DF = [(4, 2, 2), (6, 3, 3), (16, 8, 8)]
DF_PLUS = [(5, 4, 4, 4, 4), (13, 6, 6, 6, 6), (65, 16, 16, 16, 16)]
SMALL = [("dragonfly", a) for a in DF[:2]] + [("dragonfly_plus", a)
                                              for a in DF_PLUS[:2]]


def _assert_same_topology(port, ref):
    for field in ("nbrs", "nbr_port", "is_leaf", "level"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
        assert getattr(port, field).dtype == getattr(ref, field).dtype
    assert (port.name, port.kind, port.meta) == (ref.name, ref.kind,
                                                 ref.meta)
    assert port.max_ports == ref.max_ports
    assert port.n_endpoints == ref.n_endpoints
    assert port.endpoints_per_leaf == ref.endpoints_per_leaf


@pytest.mark.parametrize("args", DF, ids=str)
def test_dragonfly_matches_reference(args):
    port, ref = port_core.dragonfly(*args), jax_core.dragonfly(*args)
    _assert_same_topology(port, ref)
    assert port.kind == "direct" and port.is_leaf.all()


@pytest.mark.parametrize("args", DF_PLUS, ids=str)
def test_dragonfly_plus_matches_reference(args):
    port = port_core.dragonfly_plus(*args)
    _assert_same_topology(port, jax_core.dragonfly_plus(*args))
    assert port.kind == "indirect"


def test_figure7_shapes():
    df = port_core.dragonfly(16, 8, 8)
    assert (df.n_switches, df.max_ports, df.n_leaves, df.n_endpoints) == \
        (2064, 23, 2064, 16_512)
    dfp = port_core.dragonfly_plus(65, 16, 16, 16, 16)
    assert (dfp.n_switches, dfp.max_ports, dfp.n_leaves,
            dfp.n_endpoints) == (2080, 32, 1040, 16_640)
    leaves = dfp.nbrs[dfp.leaf_ids]
    assert (leaves[:, :16] >= 0).all() and (leaves[:, 16:] == -1).all()
    assert int((dfp.nbr_port[dfp.leaf_ids] < 0).sum()) == 16_640


def test_unbalanced_dragonfly_raises_like_reference():
    for mod in (jax_core, port_core):
        with pytest.raises(NotImplementedError, match="balanced"):
            mod.dragonfly(4, 2, 2, n_groups=5)
        with pytest.raises(ValueError, match="divide evenly"):
            mod.dragonfly_plus(4, 4, 4, 4, 4)


def _rule_products(ecc: int, n: int, n_rows: int) -> int:
    squarings = ecc.bit_length()
    per = 1 if min(-(-n_rows // 8) * 8, n) >= n else 2
    return per * (squarings - 1) + 1


@pytest.mark.parametrize("family,args", SMALL, ids=str)
def test_leaf_distances_match_reference(family, args):
    ref = jax_core.build_tables(getattr(jax_core, family)(*args))
    topo = getattr(port_core, family)(*args)
    tables = port_core.build_tables(topo, device="cpu")
    assert tables.dist_leaf.dtype == torch.int16
    np.testing.assert_array_equal(tables.dist_leaf.numpy(), ref.dist_leaf)
    leaf, _, products = hop_distances(topo.nbrs, topo.leaf_ids,
                                      torch.device("cpu"))
    np.testing.assert_array_equal(leaf.numpy(), ref.dist_leaf)
    ecc = int(ref.dist_leaf.max())
    assert ecc >= 3
    assert products == _rule_products(ecc, topo.n_switches, topo.n_leaves)


@pytest.mark.parametrize("family,params", [
    ("dragonfly", {"a": 4, "p": 2, "h": 2}),
    ("dragonfly_plus", {"n_groups": 5, "leaves_per_group": 4,
                        "spines_per_group": 4, "p": 4,
                        "global_per_spine": 4})], ids=str)
def test_dragonfly_families_through_the_spec_layer(family, params):
    spec = {"family": family, "params": params}
    port = port_api.build_network(port_api.NetworkSpec.from_dict(spec))
    ref = jax_api.build_network(jax_api.NetworkSpec.from_dict(spec))
    _assert_same_topology(port, ref)
    assert family in port_api.topology_families()
