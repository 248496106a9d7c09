"""The engine-parity golden replayed through the port, bitwise.

``tests/golden/engine_parity.json`` was captured with jax's original
(non-partitionable) threefry stream, so the port replays it with
``SimConfig(threefry_partitionable=False)``; the reference engine under
the installed jax draws the partitionable stream and no longer
reproduces this file.  Throughput, avg hops, ejected count, pool stalls
and the whole latency histogram must be exact.  No JAX run is needed.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import build_tables, mrls
from repro_torch.simulator.engine import SimConfig, Simulator, Traffic

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "engine_parity.json")
    .read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops per slot: one
    intra-op thread is faster and leaves the other cores to the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return build_tables(mrls(**GOLDEN["fabric"]), device="cpu")


@pytest.mark.parametrize("policy", ["polarized", "minimal_adaptive", "ksp",
                                    "ugal", "valiant"])
def test_golden_parity_through_port(tables, policy):
    gp = GOLDEN["policies"][policy]
    warm, measure = GOLDEN["warm"], GOLDEN["measure"]
    sim = Simulator(tables, SimConfig(policy=policy, max_hops=10, pool=4096,
                                      threefry_partitionable=False),
                    device="cpu")
    thr = sim.run_throughput(Traffic("uniform", load=0.7), warm=warm,
                             measure=measure, seed=0)
    lat = sim.run_latency(Traffic("uniform", load=0.5), warm=warm,
                          measure=measure, seed=0)
    assert thr["throughput"] == gp["throughput"]        # bitwise, no approx
    assert thr["avg_hops"] == gp["avg_hops"]
    assert thr["ejected"] == gp["ejected"]
    assert thr["pool_stall"] == gp["pool_stall"]
    golden_hist = np.zeros_like(lat["hist"])
    for bin_, count in gp["lat_hist_nonzero"].items():
        golden_hist[int(bin_)] = count
    np.testing.assert_array_equal(lat["hist"], golden_hist)
