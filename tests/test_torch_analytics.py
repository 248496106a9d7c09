"""The port's ``core.analytics`` and table metrics against the reference.

* Every function of ``analytics`` (``theta``, the costs, the Appendix-A
  recurrences, ``prob_dstar_leq``, ``mrls_design``, ``dstar_thresholds``)
  against the reference's over a grid of (n1, n2, u, R, k, f), with
  float ``==`` and ``numpy`` arrays equal element for element.
* ``exact_metrics`` and the three ``RoutingTables`` properties
  (``diameter_leaf``, ``diameter_star``, ``avg_distance_leaf``) on tables
  from the host BFS (``build_tables(device="cpu")``) and from the
  min-plus build on the plain ``minplus_hops``
  (``hop_distances(device="cpu")``), on small fabrics of every family and
  on ``oft(17)`` and ``jellyfish(614, 18, 18, seed=1)``: every field
  equal to the reference's, ``A`` as a float64 bit for bit.
* ``tests/golden/torch_table2.json``: the reference's ``exact_metrics`` of
  every row of ``benchmarks/table2.py`` (12 fabrics up to N = 23,328)
  and of ``jellyfish(614, 18, 18, seed=1)`` (the search space's design
  at radix 36 and f = 1), with the paper's values.  ``chip_smoke.py``
  phase 13 holds the port's ``exact_metrics`` on the card to it.  Here
  the OFT row is re-run through the reference, and the port's CPU
  metrics of the OFT and jellyfish rows must equal the file.

Regenerate the file with ``PYTHONPATH=src python
tests/test_torch_analytics.py --capture`` (about 5 minutes on a CPU host:
the host BFS of the 100k-endpoint rows).  Tolerance: zero.
"""
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_table2.json"


def _net(family, **params):
    return {"family": family, "params": params}


def _mrls(n_leaves, u, d):
    return _net("mrls", n_leaves=n_leaves, u=u, d=d, seed=1)


# benchmarks/table2.py ROWS: (label, network, paper cost_links,
# cost_switches, D, theta), and the jellyfish design of the search space
TABLE2 = [
    ("MRLS(36,11052)u18", _mrls(614, 18, 18), 1.0, 0.083, 4, 0.748),
    ("MRLS(36,11160)u21", _mrls(744, 21, 15), 1.4, 0.106, 4, 1.029),
    ("MRLS(36,11664)u24", _mrls(972, 24, 12), 2.0, 0.139, 4, 1.420),
    ("MRLS(36,104976)u18", _mrls(5832, 18, 18), 1.0, 0.083, 4, 0.527),
    ("MRLS(36,104976)u24", _mrls(8748, 24, 12), 2.0, 0.139, 4, 1.048),
    ("MRLS(36,104976)u27", _mrls(11664, 27, 9), 3.0, 0.194, 4, 1.561),
    ("MRLS(32,16640)u19", _mrls(1280, 19, 13), 1.462, 0.122, 4, 0.900),
    ("OFT(36,11052)", _net("oft", q=17), 1.0, 0.083, 2, 1.0),
    ("FT(36,11664)", _net("fat_tree", radix=36, h=2), 2.0, 0.139, 4, 1.0),
    ("FT(36,104976)50%", _net("fat_tree", radix=36, h=3, a1=18), 3.0,
     0.222, 6, 1.0),
    ("DF+(32,16640)", _net("dragonfly_plus", n_groups=65,
                           leaves_per_group=16, spines_per_group=16, p=16,
                           global_per_spine=16), 1.5, 0.127, 3, 1.0),
    ("DF(32,16512)", _net("dragonfly", a=16, p=8, h=8), 1.5, 0.125, 3, 1.0),
    ("JF(36,11052)r18", _net("jellyfish", n_switches=614, r=18, d=18,
                             seed=1), None, None, None, None),
]
RERUN = "OFT(36,11052)"
PORT_CPU_ROWS = ("OFT(36,11052)", "JF(36,11052)r18")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_row(network: dict) -> dict:
    """The reference's ``exact_metrics`` of one fabric, by host BFS."""
    import repro.api as jax_api
    from repro.core import build_tables, exact_metrics
    topo = jax_api.build_network(jax_api.NetworkSpec.from_dict(network))
    # the blocked layout skips the mask packing; the distances are the same
    return dataclasses.asdict(exact_metrics(
        topo, build_tables(topo, masks="blocked")))


def capture() -> None:
    rows = []
    for label, network, cl, cs, d, th in TABLE2:
        paper = (None if cl is None else
                 {"cost_links": cl, "cost_switches": cs, "D": d,
                  "theta": th})
        rows.append({"label": label, "network": network, "paper": paper,
                     "metrics": reference_row(network)})
        print(f"{label}: {rows[-1]['metrics']}", flush=True)
    GOLDEN.write_text(json.dumps({"rows": rows}, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


# ---------------------------------------------------------------------- #
# analytics functions
# ---------------------------------------------------------------------- #
# (n1, n2, u, R): Figure 5's MRLS, Figure 6's f1, a thick one, small ones
DESIGNS = [(614, 307, 18, 36), (5832, 2916, 18, 36), (972, 648, 24, 36),
           (62, 31, 6, 12), (14, 7, 3, 6), (1280, 760, 19, 32)]


@pytest.mark.parametrize("n1,n2,u,R", DESIGNS, ids=str)
def test_mrls_recurrences_equal_reference(n1, n2, u, R):
    from repro.core import analytics as ref
    from repro_torch.core import analytics as port
    got = port.mrls_distance_distribution(n1, n2, u, R)
    want = ref.mrls_distance_distribution(n1, n2, u, R)
    assert set(got) == set(want) == {1, 2}
    for i in (1, 2):
        for k in ("b", "n"):
            assert got[i][k].dtype == want[i][k].dtype
            np.testing.assert_array_equal(got[i][k], want[i][k])
    assert port.mrls_expected_A(n1, n2, u, R) == \
        ref.mrls_expected_A(n1, n2, u, R)
    assert port.mrls_expected_A_star(n1, n2, u, R) == \
        ref.mrls_expected_A_star(n1, n2, u, R)
    for k in range(0, 10):
        assert port.prob_dstar_leq(n1, n2, u, R, k) == \
            ref.prob_dstar_leq(n1, n2, u, R, k), k


@pytest.mark.parametrize("R,f", [(36, 1.0), (36, 2.0), (32, 19 / 13),
                                 (12, 1.0), (36, 0.5)], ids=str)
def test_design_and_thresholds_equal_reference(R, f):
    from repro.core import analytics as ref
    from repro_torch.core import analytics as port
    for s in (100, 11_052, 16_640, 104_976, 1_000_003):
        assert port.mrls_design(s, R, f) == ref.mrls_design(s, R, f)
    got, want = port.dstar_thresholds(R, f), ref.dstar_thresholds(R, f)
    assert got == want
    assert all(isinstance(v, float) for v in got.values())


def test_exact_metric_formulas_equal_reference():
    from repro.core import analytics as ref
    from repro_torch.core import analytics as port
    for M, S, N, A in ((11052, 11052, 921, 3.1), (314928, 104976, 23328, 5.0),
                       (3, 7, 2, 1.0 / 3), (0, 1, 1, 2.5)):
        assert port.theta(M, S, A) == ref.theta(M, S, A)
        assert port.cost_links(M, S) == ref.cost_links(M, S)
        assert port.cost_switches(N, S) == ref.cost_switches(N, S)
    assert port.theta(1, 3, 3.0) == ref.theta(1, 3, 3.0)
    for x, y, n in ((3.0, 4.0, 10.0), (6.5, 4.0, 10.0), (0.0, 0.0, 1.0)):
        assert port._log_p_empty(x, y, n) == ref._log_p_empty(x, y, n)
    assert math.isinf(port._log_p_empty(6.5, 4.0, 10.0))


# ---------------------------------------------------------------------- #
# exact_metrics and the table properties
# ---------------------------------------------------------------------- #
SMALL = [
    ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
    ("mrls", dict(n_leaves=62, u=6, d=6, seed=1)),
    ("fat_tree", dict(radix=6, h=2)),
    ("fat_tree", dict(radix=8, h=3, a1=4)),
    ("oft", dict(q=5)),
    ("rfc", dict(n_leaves=64, u=12, d=12, seed=0)),
    ("dragonfly", dict(a=4, p=2, h=2)),
    ("dragonfly_plus", dict(n_groups=5, leaves_per_group=4,
                            spines_per_group=4, p=4, global_per_spine=4)),
    ("jellyfish", dict(n_switches=40, r=5, d=3, seed=2)),
]


def _metrics_dict(m) -> dict:
    d = dataclasses.asdict(m)
    assert type(d["A"]) is float and type(d["theta"]) is float
    return d


def _port_tables(topo, route: str, full: bool):
    """The port's tables of ``topo`` by the host BFS, or by the min-plus
    build on the plain ``minplus_hops`` (the card's algorithm on the
    CPU)."""
    from repro_torch.core import RoutingTables, build_tables
    from repro_torch.core.routing import hop_distances
    if route == "bfs":
        return build_tables(topo, full=full, device="cpu")
    dist_leaf, dist_full, products = hop_distances(
        topo.nbrs, topo.leaf_ids, "cpu", full=full)
    return RoutingTables(topo, dist_leaf, topo.leaf_rank(), dist_full,
                         squarings=products)


@pytest.mark.parametrize("route", ["bfs", "minplus"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("family,params", SMALL,
                         ids=[f"{f}{tuple(p.values())}" for f, p in SMALL])
def test_exact_metrics_equal_reference(family, params, route, full):
    import repro.core as jax_core
    import repro_torch.core as port_core
    ref_topo = getattr(jax_core, family)(**params)
    topo = getattr(port_core, family)(**params)
    want_tables = jax_core.build_tables(ref_topo, full=full)
    tables = _port_tables(topo, route, full)
    for prop in ("diameter_leaf", "diameter_star", "avg_distance_leaf"):
        got, want = getattr(tables, prop), getattr(want_tables, prop)
        assert type(got) is type(want), prop
        assert got == want, prop
    got = port_core.exact_metrics(topo, tables)
    want = jax_core.exact_metrics(ref_topo, want_tables)
    assert _metrics_dict(got) == _metrics_dict(want)
    assert got.row() == want.row()


def test_exact_metrics_builds_its_tables_on_the_requested_device():
    import repro.core as jax_core
    import repro_torch.core as port_core
    topo = port_core.oft(3)
    want = jax_core.exact_metrics(jax_core.oft(3))
    assert _metrics_dict(port_core.exact_metrics(topo, device="cpu")) == \
        _metrics_dict(want)
    full = jax_core.exact_metrics(jax_core.oft(3), full=True)
    assert _metrics_dict(port_core.exact_metrics(
        topo, full=True, device="cpu")) == _metrics_dict(full)
    assert full.D_star >= want.D_star == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_core.exact_metrics(topo)


# ---------------------------------------------------------------------- #
# the Table-2 golden
# ---------------------------------------------------------------------- #
def _golden_rows() -> dict:
    return {r["label"]: r for r in json.loads(GOLDEN.read_text())["rows"]}


def test_table2_golden_records_the_rows():
    rows = _golden_rows()
    assert list(rows) == [r[0] for r in TABLE2]
    for label, network, cl, cs, d, th in TABLE2:
        row = rows[label]
        assert row["network"] == network
        m = row["metrics"]
        if cl is None:
            assert row["paper"] is None
        else:
            assert row["paper"] == {"cost_links": cl, "cost_switches": cs,
                                    "D": d, "theta": th}
            # the paper's D; its costs and Theta are rounded, and its
            # Dragonfly's link cost counts another wiring (1.5 against
            # the `dragonfly` constructor's 1.4375)
            assert m["D"] == d, label
        assert m["D_star"] >= m["D"] >= 1 and m["A"] >= 1.0
    assert rows[RERUN]["metrics"]["D"] == 2
    assert rows[RERUN]["metrics"]["D_star"] == 3


def test_table2_oft_row_matches_reference():
    rows = _golden_rows()
    network = dict(zip([r[0] for r in TABLE2], [r[1] for r in TABLE2]))
    assert rows[RERUN]["metrics"] == reference_row(network[RERUN])


@pytest.mark.parametrize("route", ["bfs", "minplus"])
@pytest.mark.parametrize("label", PORT_CPU_ROWS)
def test_table2_port_rows_on_the_cpu(label, route):
    import repro_torch.api as port_api
    from repro_torch.core import exact_metrics
    row = _golden_rows()[label]
    topo = port_api.build_network(
        port_api.NetworkSpec.from_dict(row["network"]))
    tables = _port_tables(topo, route, full=False)
    assert dataclasses.asdict(exact_metrics(topo, tables)) == row["metrics"]
    if route == "bfs":
        assert dataclasses.asdict(exact_metrics(topo, device="cpu")) == \
            row["metrics"]


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_analytics.py "
                 "--capture")
    capture()
