"""The port's ``oft``, ``rfc`` and ``jellyfish`` against the reference's.

Same arguments -> identical ``nbrs``, ``nbr_port``, ``is_leaf``,
``level``, ``name``, ``kind``, ``max_ports`` and ``meta``:

* ``oft(q)`` for q = 2, 3, 5, 7 and 17 (Figure 5's 921 switches, 614
  leaves, 11,052 endpoints, P 36, leaf-leaf diameter 2), and a non-prime
  q refused with the reference's error;
* ``rfc(64, 12, 12)`` for several seeds (``meta["rerolls"]``), and the
  failure past the diameter-2 regime (``rfc(128, 18, 18)``);
* ``jellyfish`` on the cases of ``tests/test_topology.py``: the complete
  graph at ``r = n - 1``, the four errors, determinism and seed
  sensitivity, and a grid of (n, r, d, seed), including a seed the
  repair cannot make simple; and Table 2's ``jellyfish(614, 18, 18,
  seed=1)``.

Each family also resolves through ``repro_torch.api.build_network``.
Tolerance: zero.
"""
import numpy as np
import pytest

import repro.api as jax_api
import repro.core as jax_core
import repro_torch.api as port_api
import repro_torch.core as port_core

FIELDS = ("nbrs", "nbr_port", "is_leaf", "level")


def _assert_same_topology(port, ref):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
        assert getattr(port, field).dtype == getattr(ref, field).dtype
    assert (port.name, port.kind, port.meta) == (ref.name, ref.kind,
                                                 ref.meta)
    assert port.max_ports == ref.max_ports
    assert port.n_endpoints == ref.n_endpoints
    assert port.endpoints_per_leaf == ref.endpoints_per_leaf


def _both(family, *args, **kw):
    return (getattr(port_core, family)(*args, **kw),
            getattr(jax_core, family)(*args, **kw))


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("q", [2, 3, 5, 7, 17])
def test_oft_matches_reference(q):
    port, ref = _both("oft", q)
    _assert_same_topology(port, ref)
    m = q * q + q + 1
    assert (port.n_switches, port.n_leaves) == (3 * m, 2 * m)
    assert port.max_ports == 2 * (q + 1) and port.kind == "indirect"
    tables = port_core.build_tables(port, device="cpu")
    assert tables.diameter_leaf == 2       # any two leaves share a spine


def test_oft_figure5_shape():
    t = port_core.oft(17)
    assert (t.n_switches, t.n_leaves, t.n_endpoints, t.max_ports) == \
        (921, 614, 11_052, 36)


@pytest.mark.parametrize("q", [0, 1, 4, 6, 9])
def test_oft_refuses_non_prime_q_like_reference(q):
    want = _raised(lambda: jax_core.oft(q))
    assert want[0] is NotImplementedError
    assert _raised(lambda: port_core.oft(q)) == want


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_rfc_matches_reference(seed):
    port, ref = _both("rfc", 64, 12, 12, seed=seed)
    _assert_same_topology(port, ref)
    assert "rerolls" in port.meta
    dist = port_core.bfs_distances(port, port.leaf_ids)
    assert dist[:, port.leaf_ids].max() <= 2


def test_rfc_refuses_past_diameter_two_like_reference():
    want = _raised(lambda: jax_core.rfc(128, 18, 18, seed=1, max_tries=3))
    assert want[0] is ValueError and "D=2" in want[1]
    assert _raised(lambda: port_core.rfc(128, 18, 18, seed=1,
                                         max_tries=3)) == want


# the cases of tests/test_topology.py and a grid of (n, r, d, seed)
JELLYFISH = [(32, 6, 4, 0), (24, 5, 3, 7), (24, 5, 3, 8), (9, 8, 4, 0),
             (40, 5, 3, 2), (8, 3, 1, 0), (16, 4, 2, 3), (50, 7, 5, 10),
             (64, 8, 6, 4), (12, 6, 2, 1), (614, 18, 18, 1)]


@pytest.mark.parametrize("args", JELLYFISH, ids=str)
def test_jellyfish_matches_reference(args):
    n, r, d, seed = args
    port, ref = _both("jellyfish", n, r, d, seed=seed)
    _assert_same_topology(port, ref)
    port.validate()
    assert port.kind == "direct" and port.is_leaf.all()
    assert port.max_ports == r and (port.degrees == r).all()
    assert port.n_endpoints == n * d


def test_jellyfish_complete_graph_and_seeds():
    k9 = port_core.jellyfish(9, r=8, d=4, seed=0)
    assert port_core.build_tables(k9, device="cpu").diameter_leaf == 1
    a, b, c = (port_core.jellyfish(24, r=5, d=3, seed=s) for s in (7, 7, 8))
    assert np.array_equal(a.nbrs, b.nbrs)
    assert not np.array_equal(a.nbrs, c.nbrs)


# the four argument errors, then two graphs too dense to repair
@pytest.mark.parametrize("args", [(8, 1, 4), (8, 8, 4), (7, 3, 4),
                                  (8, 4, 0), (10, 8, 2, 1), (6, 4, 1, 0, 1)],
                         ids=str)
def test_jellyfish_refuses_like_reference(args):
    want = _raised(lambda: jax_core.jellyfish(*args))
    assert want[0] is ValueError
    assert _raised(lambda: port_core.jellyfish(*args)) == want


@pytest.mark.parametrize("family,params", [
    ("oft", {"q": 5}),
    ("rfc", {"n_leaves": 64, "u": 12, "d": 12, "seed": 0}),
    ("jellyfish", {"n_switches": 40, "r": 5, "d": 3, "seed": 2})])
def test_families_resolve_through_the_spec_layer(family, params):
    spec = {"family": family, "params": params}
    _assert_same_topology(
        port_api.build_network(port_api.NetworkSpec.from_dict(spec)),
        jax_api.build_network(jax_api.NetworkSpec.from_dict(spec)))
    assert family in port_api.topology_families()
