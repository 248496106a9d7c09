"""Routing tables computed on a device against the reference's tables.

``build_tables(topo, device="cpu")`` keeps the BFS and gives the
reference's ``dist_leaf``; the min-plus fixpoint the card uses gives the
same int16 table.  The simulator packs its ``[N1*N, W]`` port-mask words
on its own device from those distances, in blocks of leaf rows; the
words must equal the reference's ``RoutingTables.mask_blocks()`` as
int32 views, in its dense and its blocked layout.  Fabrics: the golden
MRLS, the Figure-5 MRLS (P = 36, so bit 31 of the second word is set)
and a depopulated Fat-Tree.  Tolerance: zero.
"""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro_torch.core.routing import _hops_int16, minplus_distances
from repro_torch.simulator.engine import SimConfig, Simulator

FABRICS = {
    "mrls_golden": lambda m: m.mrls(14, 3, 3, seed=0),
    "mrls_fig5_u18": lambda m: m.mrls(614, 18, 18, seed=1),
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


@pytest.fixture(scope="module", params=sorted(FABRICS))
def both(request):
    make = FABRICS[request.param]
    return make(jax_core), make(port_core)


def test_cpu_tables_keep_the_reference_bfs(both):
    ref, port = both
    want = jax_core.build_tables(ref, full=True)
    got = port_core.build_tables(port, full=True, device="cpu")
    assert got.squarings == 0
    for field in ("dist_leaf", "dist_full", "leaf_rank"):
        got_f = np.asarray(getattr(got, field))
        np.testing.assert_array_equal(got_f, getattr(want, field),
                                      err_msg=field)
        assert got_f.dtype == getattr(want, field).dtype


def test_minplus_fixpoint_equals_the_bfs(both):
    ref, port = both
    with torch.inference_mode():
        d, squarings = minplus_distances(port, torch.device("cpu"))
    full = _hops_int16(d).numpy()
    assert full.dtype == np.int16
    np.testing.assert_array_equal(
        full, jax_core.bfs_distances(ref, np.arange(ref.n_switches)))
    np.testing.assert_array_equal(full[port.leaf_ids],
                                  jax_core.build_tables(ref).dist_leaf)
    assert squarings >= 2


def _reference_words(tables, w):
    """The reference's mask words as int32 [N1*N, W] views."""
    mins, aways = [], []
    for _lo, _hi, min_b, away_b in tables.mask_blocks():
        mins.append(min_b.reshape(-1, w).view(np.int32))
        aways.append(away_b.reshape(-1, w).view(np.int32))
    return np.concatenate(mins), np.concatenate(aways)


@pytest.mark.parametrize("layout,block", [("dense", 256), ("blocked", 256),
                                          ("blocked", 100)])
@pytest.mark.parametrize("policy", ["polarized", "minimal_adaptive"])
def test_device_mask_words_match_reference(both, layout, block, policy):
    ref, port = both
    want_t = jax_core.build_tables(ref, masks=layout, leaf_block=block)
    got_t = port_core.build_tables(port, leaf_block=block, device="cpu")
    sim = Simulator(got_t, SimConfig(policy=policy), device="cpu")
    want_min, want_away = _reference_words(want_t, sim.W)
    assert sim.min_mask.dtype == torch.int32
    np.testing.assert_array_equal(sim.min_mask.numpy(), want_min)
    if policy == "polarized":
        np.testing.assert_array_equal(sim.away_mask.numpy(), want_away)
    else:
        assert sim.away_mask is None
    if port.max_ports == 36:
        # port 31 leads toward some leaf from some switch: bit 31 is set
        assert (want_min[:, 0] < 0).any()
