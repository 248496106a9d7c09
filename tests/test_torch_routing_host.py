"""The port's host router against the reference's, path for path.

``polarized_port_mask``, ``route_packet_host`` and ``find_corners`` are
numpy in both packages (``src/repro/core/routing.py``).  On the golden
``mrls(14, 3, 3)`` and on ``dragonfly(4, 2, 2)``, with the same seeded
``rng`` and a seeded synthetic occupancy: every leaf pair under each of
the five policies gives the same path, or the same error; the corner
counts agree.  The port's tables here come from its host BFS.
Tolerance: zero.
"""
import numpy as np
import pytest

import repro.core as jax_core
import repro_torch.core as port_core

FABRICS = {"mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
           "df": ("dragonfly", dict(a=4, p=2, h=2))}
POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant")


@pytest.fixture(scope="module")
def tables():
    return {name: (jax_core.build_tables(getattr(jax_core, fam)(**params)),
                   port_core.build_tables(getattr(port_core, fam)(**params),
                                          device="cpu"))
            for name, (fam, params) in FABRICS.items()}


def _route(mod, tables, a, b, policy, occ, rng, **kw):
    try:
        return mod.route_packet_host(tables, a, b, policy, occupancy=occ,
                                     rng=rng, **kw)
    except RuntimeError as e:
        return str(e)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_route_packet_host_equals_reference(tables, fabric, policy):
    jt, pt = tables[fabric]
    leaves = [int(x) for x in jt.topo.leaf_ids]
    occ = np.random.default_rng(4).integers(
        0, 6, jt.topo.nbrs.shape).astype(np.float64)
    rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
    paths = 0
    for a in leaves:
        for b in leaves:
            if a == b:
                continue
            want = _route(jax_core.routing, jt, a, b, policy, occ, rng_j)
            got = _route(port_core.routing, pt, a, b, policy, occ, rng_p)
            assert got == want, (a, b)
            paths += isinstance(got, list)
    assert paths > 0
    # the two generators drew the same numbers
    assert rng_j.integers(1 << 30) == rng_p.integers(1 << 30)


def test_a_short_budget_fails_alike(tables):
    jt, pt = tables["mrls"]
    a, b = (int(x) for x in jt.topo.leaf_ids[[0, -1]])
    for policy in ("polarized", "ksp"):
        want = _route(jax_core.routing, jt, a, b, policy, None,
                      np.random.default_rng(1), max_hops=1)
        got = _route(port_core.routing, pt, a, b, policy, None,
                     np.random.default_rng(1), max_hops=1)
        assert got == want and isinstance(got, str)


def test_polarized_port_mask_equals_reference():
    rng = np.random.default_rng(3)
    d_cs, d_ct = rng.integers(0, 5, (2, 64, 1)).astype(np.int16)
    d_ns, d_nt = rng.integers(0, 5, (2, 64, 9)).astype(np.int16)
    hops = rng.integers(0, 6, (64, 1))
    valid = rng.random((64, 9)) < 0.8
    want = jax_core.routing.polarized_port_mask(d_cs, d_ct, d_ns, d_nt,
                                                hops, 6, valid)
    got = port_core.polarized_port_mask(d_cs, d_ct, d_ns, d_nt, hops, 6,
                                        valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and got[1].any()


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_find_corners_equals_reference(tables, fabric):
    jt, pt = tables[fabric]
    for seed in (0, 5):
        assert (port_core.find_corners(pt, n_samples=300, seed=seed)
                == jax_core.routing.find_corners(jt, n_samples=300,
                                                 seed=seed))
