"""The port's fabric planner against the reference's: the efficiency
table, its calibration from search records, the fabric models, the
collective times and the pod-axis plan, each with float ``==``."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.fabric.planner as jax_planner
import repro_torch.fabric as port_fabric
import repro_torch.fabric.planner as port_planner

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "torch_search_1k_uniform_cut.json"


def test_tables_equal_the_reference():
    assert port_planner.DEFAULT_PATTERN_EFF == jax_planner.DEFAULT_PATTERN_EFF
    assert port_fabric.PATTERN_EFF == jax_planner.PATTERN_EFF
    assert port_planner.load_pattern_eff() == jax_planner.load_pattern_eff()
    assert port_planner.CALIB_PATH == jax_planner.CALIB_PATH
    assert port_planner.CALIB_PATH.is_file()
    for fam in ("mrls", "fat_tree", "dragonfly"):
        for pattern in ("all2all", "allreduce", "uniform"):
            assert 0.0 < port_fabric.PATTERN_EFF[fam][pattern] <= 1.0


def test_load_pattern_eff_overlays_defaults(tmp_path):
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps(
        {"eff": {"mrls": {"all2all": 0.77}, "jellyfish": {"uniform": 0.5}}}))
    for path in (calib, tmp_path / "missing.json"):
        assert (port_planner.load_pattern_eff(path)
                == jax_planner.load_pattern_eff(path))
    assert port_planner.load_pattern_eff(calib)["mrls"]["all2all"] == 0.77
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert (port_planner.load_pattern_eff(bad)
            == {f: dict(p) for f, p in
                port_planner.DEFAULT_PATTERN_EFF.items()})


def _records():
    rec = {"spec": {"workload": {"pattern": "uniform"}},
           "candidates": [
               {"status": "full", "family": "mrls", "theta": 0.8,
                "throughput": 0.6},
               {"status": "full", "family": "mrls", "theta": 2.0,
                "throughput": 0.9},
               {"status": "full", "family": "jellyfish", "theta": 0.0,
                "throughput": 0.9},
               {"status": "pruned", "family": "mrls"}]}
    a2a = {"spec": {"workload": {"pattern": "all2all"}},
           "candidates": [{"status": "full", "family": "fat_tree",
                           "theta": 1.2, "throughput": 1.5}]}
    other = {"spec": {"workload": {"pattern": "bursty"}},
             "candidates": rec["candidates"]}
    golden = json.loads(GOLDEN.read_text())["record"]
    return [rec, {"searches": [rec, a2a, other]}, [rec, a2a], golden,
            {"searches": [golden, rec]}]


@pytest.mark.parametrize("i", range(5))
def test_pattern_eff_from_search_equals_the_reference(i):
    records = _records()[i]
    got = port_planner.pattern_eff_from_search(records)
    assert got == jax_planner.pattern_eff_from_search(records)
    assert got


@pytest.mark.parametrize("kind", ["mrls", "fat_tree", "dragonfly"])
@pytest.mark.parametrize("n", [64, 512, 4096, 104976])
def test_build_fabric_and_collective_times_equal_the_reference(kind, n):
    for radix, f, gbps in ((64, 2.0, 400.0), (36, 1.0, 200.0),
                           (16, 3.0, 100.0)):
        got = port_planner.build_fabric(kind, n, radix=radix, f=f,
                                        link_gbps=gbps)
        ref = jax_planner.build_fabric(kind, n, radix=radix, f=f,
                                       link_gbps=gbps)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        for pattern in ("all2all", "allreduce", "uniform"):
            for b in (0.0, 1.0, 3.5e6, 2.0 ** 40):
                assert (port_planner.collective_time_s(got, pattern, b)
                        == jax_planner.collective_time_s(ref, pattern, b))
    with pytest.raises(ValueError):
        port_planner.build_fabric("torus", n)


@pytest.mark.parametrize("seed", range(4))
def test_plan_pod_axis_equals_the_reference(seed):
    """A dry-run record (the reference's ``repro.launch.dryrun`` JSON,
    given as a dict) with seeded collective bytes."""
    rng = np.random.default_rng(seed)
    keys = ("all-to-all", "all-reduce", "reduce-scatter", "all-gather")
    coll = {k: float(rng.integers(0, 1 << 34)) for k in keys
            if rng.random() < 0.8}
    record = {"per_device": {"collective_bytes": coll}}
    for pods, compute, gbps in ((512, None, 400.0), (64, 0.01, 100.0),
                                (4096, 10.0, 800.0)):
        got = port_fabric.plan_pod_axis(record, pods, compute, gbps)
        ref = jax_planner.plan_pod_axis(record, pods, compute, gbps)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.recommended_fabric == got.fabric_ranking[0][0]
