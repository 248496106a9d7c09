"""The JAX reference's open-loop serving Results that ``chip_smoke.py``
holds the port to on the card, and the shorter engine golden of its
phase 4.

``chip_smoke.py`` phase 16 runs four points on the two 1k-endpoint
fabrics of ``examples/specs/serve_1k.json`` -- the MRLS
``mrls(56, 18, 18, seed=1)`` (1,008 endpoints, Polarized, ``max_hops``
8) and the Fat-Tree ``fat_tree(16, 2)`` (1,024 endpoints,
minimal_adaptive, ``max_hops`` 6) -- and holds each, field for field,
to the reference's record committed here:

* ``torch_serve_mrls_poisson_sweep.json`` -- ``serve_sweep`` of the
  MRLS poisson spec at loads 0.6 and 0.8, warm 50 / measure 100, with
  the bridge's request leg ``qwen3-1.7b`` / ``decode`` / 8 ranks: the
  SLO record (points, saturation, request);
* ``torch_serve_ft_poisson_r4.json`` -- poisson at load 0.8 on the
  Fat-Tree through ``run`` with ``replicas=4`` (the batched serving
  path), warm 50 / measure 100;
* ``torch_serve_mrls_pareto.json`` -- bounded-Pareto batches (alpha
  1.5, cap 32) at load 0.6 on the MRLS, warm 64 / measure 192;
* ``torch_serve_mrls_diurnal.json`` -- the diurnal source (amplitude
  0.5, period 64) at load 0.6 on the MRLS, warm 64 / measure 64.

The loads and windows are the spec file's cut for time (its sweeps run
seven loads at warm 200 / measure 600); the sweep's, the Fat-Tree's
and the diurnal point's windows were cut again, from 100 + 200, 100 +
300 and 64 + 192 slots, to make room on the card for the training of
the SSM kinds (``chip_smoke.py`` phase 28).  The runs take minutes on a
CPU, so the test checks that each file records its point; the port's
arrival branch is held to the live reference on small fabrics in
``tests/test_torch_serving.py``.

``torch_engine_parity_short.json`` is ``engine_parity.json``'s point
(``mrls(14, 3, 3, seed=0)``, ``SimConfig(max_hops=10, pool=4096)``, the
five policies, uniform 0.7 throughput and 0.5 latency) at warm 20 /
measure 40, captured with jax's original threefry stream
(``JAX_THREEFRY_PARTITIONABLE=0``, set in a subprocess); the test
replays it through the port on the CPU
(``SimConfig(threefry_partitionable=False)``).

Regenerate the files with ``PYTHONPATH=src python
tests/test_torch_serving_reference.py --capture [file ...]``.
Tolerance: zero.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_1K = ROOT / "examples" / "specs" / "serve_1k.json"
ENGINE_GOLDEN = GOLDEN_DIR / "engine_parity.json"

SHORT = "torch_engine_parity_short.json"
SWEEP = "torch_serve_mrls_poisson_sweep.json"
FT_R4 = "torch_serve_ft_poisson_r4.json"
PARETO = "torch_serve_mrls_pareto.json"
DIURNAL = "torch_serve_mrls_diurnal.json"
SERVING_FILES = (SWEEP, FT_R4, PARETO, DIURNAL)
POLICIES = ("polarized", "minimal_adaptive", "ksp", "ugal", "valiant")
SHORT_WARM, SHORT_MEASURE = 20, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_1k(name: str) -> dict:
    """One ServingSpec dict of ``examples/specs/serve_1k.json``."""
    doc = json.loads(SERVE_1K.read_text())
    return next(d for d in doc["servings"] if d["name"] == name)


def sweep_spec() -> dict:
    """Point a: the MRLS poisson sweep, cut to two loads and 150 slots,
    with the decode request of qwen3-1.7b over 8 ranks."""
    return dict(serve_1k("serve.1k.mrls.poisson"), loads=[0.6, 0.8],
                warm=50, measure=100, model="qwen3-1.7b", phase="decode",
                ranks=8)


def _experiment(spec_name: str, workload: dict, name: str, *, warm: int,
                measure: int, replicas: int = 1) -> dict:
    spec = serve_1k(spec_name)
    return {"network": spec["network"], "route": spec["route"],
            "workload": workload, "name": name, "warm": warm,
            "measure": measure, "replicas": replicas}


def experiment_points() -> dict:
    """Points b-d as experiment dicts, by golden file."""
    return {
        FT_R4: _experiment("serve.1k.fat_tree.poisson",
                           {"pattern": "poisson", "load": 0.8},
                           "serve.1k.fat_tree.poisson@0.8", warm=50,
                           measure=100, replicas=4),
        PARETO: _experiment("serve.1k.mrls.pareto",
                            {"pattern": "pareto", "load": 0.6,
                             "pareto_alpha": 1.5, "pareto_cap": 32},
                            "serve.1k.mrls.pareto@0.6", warm=64,
                            measure=192),
        DIURNAL: _experiment("serve.1k.mrls.poisson",
                             {"pattern": "diurnal", "load": 0.6,
                              "diurnal_amp": 0.5, "diurnal_period": 64},
                             "serve.1k.mrls.diurnal@0.6", warm=64,
                             measure=64),
    }


def _short_record() -> dict:
    """The reference engine at ``engine_parity.json``'s point, shorter
    (the stream of the running jax: set JAX_THREEFRY_PARTITIONABLE=0)."""
    from repro.core import build_tables, mrls
    from repro.simulator.engine import SimConfig, Simulator, Traffic
    fabric = json.loads(ENGINE_GOLDEN.read_text())["fabric"]
    tables = build_tables(mrls(**fabric))
    out = {"fabric": fabric, "warm": SHORT_WARM, "measure": SHORT_MEASURE,
           "policies": {}}
    for policy in POLICIES:
        with Simulator(tables, SimConfig(policy=policy, max_hops=10,
                                         pool=4096)) as sim:
            thr = sim.run_throughput(Traffic("uniform", load=0.7),
                                     warm=SHORT_WARM,
                                     measure=SHORT_MEASURE, seed=0)
            lat = sim.run_latency(Traffic("uniform", load=0.5),
                                  warm=SHORT_WARM, measure=SHORT_MEASURE,
                                  seed=0)
        out["policies"][policy] = {
            "throughput": thr["throughput"], "avg_hops": thr["avg_hops"],
            "ejected": thr["ejected"], "pool_stall": thr["pool_stall"],
            "lat_hist_nonzero": {str(i): int(c) for i, c in
                                 enumerate(np.asarray(lat["hist"])) if c}}
    return out


def reference_record(fname):
    """The reference package's record of one golden file."""
    if fname == SHORT:
        return _short_record()
    if fname == SWEEP:
        from repro.serving import ServingSpec, serve_sweep
        return serve_sweep(ServingSpec.from_dict(sweep_spec()))
    from repro.api import Experiment, run
    return run(Experiment.from_dict(experiment_points()[fname])).to_dict()


def capture(names=(SHORT,) + SERVING_FILES) -> None:
    """Write the reference records of ``names`` into ``tests/golden``;
    the short engine golden in a child process on jax's original
    threefry stream."""
    for fname in names:
        path = GOLDEN_DIR / fname
        if fname == SHORT and os.environ.get(
                "JAX_THREEFRY_PARTITIONABLE") != "0":
            subprocess.run([sys.executable, __file__, "--capture", SHORT],
                           env={**os.environ,
                                "JAX_THREEFRY_PARTITIONABLE": "0"},
                           check=True)
            continue
        path.write_text(json.dumps(reference_record(fname), indent=1,
                                   sort_keys=True) + "\n")
        print(f"wrote {path}", flush=True)


def _load(fname):
    return json.loads((GOLDEN_DIR / fname).read_text())


# ---------------------------------------------------------------------- #
# the short engine golden
# ---------------------------------------------------------------------- #
def test_short_golden_records_the_parity_point():
    short, full = _load(SHORT), json.loads(ENGINE_GOLDEN.read_text())
    assert short["fabric"] == full["fabric"]
    assert (short["warm"], short["measure"]) == (SHORT_WARM, SHORT_MEASURE)
    assert sorted(short["policies"]) == sorted(full["policies"])
    for policy, rec in short["policies"].items():
        assert sorted(rec) == sorted(full["policies"][policy])
        assert rec["ejected"] > 0 and rec["lat_hist_nonzero"]


@pytest.fixture(scope="module")
def short_tables():
    from repro_torch.core import build_tables, mrls
    return build_tables(mrls(**_load(SHORT)["fabric"]), device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_short_golden_through_port(short_tables, policy):
    from repro_torch.simulator.engine import SimConfig, Simulator, Traffic
    g = _load(SHORT)
    gp = g["policies"][policy]
    sim = Simulator(short_tables,
                    SimConfig(policy=policy, max_hops=10, pool=4096,
                              threefry_partitionable=False), device="cpu")
    thr = sim.run_throughput(Traffic("uniform", load=0.7), warm=g["warm"],
                             measure=g["measure"])
    lat = sim.run_latency(Traffic("uniform", load=0.5), warm=g["warm"],
                          measure=g["measure"])
    assert thr["throughput"] == gp["throughput"]
    assert thr["avg_hops"] == gp["avg_hops"]
    assert thr["ejected"] == gp["ejected"]
    assert thr["pool_stall"] == gp["pool_stall"]
    assert {str(i): int(c) for i, c in enumerate(lat["hist"]) if c} \
        == gp["lat_hist_nonzero"]


# ---------------------------------------------------------------------- #
# the phase-16 serving goldens
# ---------------------------------------------------------------------- #
LATENCY = ("p50", "p99", "p999", "p9999")


def test_sweep_golden_records_the_spec():
    from repro_torch.serving import ServingSpec
    rec = _load(SWEEP)
    spec = ServingSpec.from_dict(sweep_spec())
    assert rec["spec"] == spec.to_dict()
    assert rec["name"] == spec.label() == "serve.1k.mrls.poisson"
    assert [p["load"] for p in rec["points"]] == [0.6, 0.8]
    for p in rec["points"]:
        assert sorted(p) == sorted(("load", "offered", "delivered",
                                    "dropped", "pool_stall") + LATENCY)
        assert 0 < p["delivered"] and 0 < p["offered"]
        assert all(p[k] is not None for k in LATENCY)
    req = rec["request"]
    assert (req["model"], req["phase"], req["pattern"]) == (
        "qwen3-1.7b", "decode", "lm_decode")
    assert req["shape"]["ranks"] == 8 and req["completed"] is True


@pytest.mark.parametrize("fname", (FT_R4, PARETO, DIURNAL))
def test_serving_golden_records_its_point(fname):
    from repro_torch.api import Experiment, Result
    rec = _load(fname)
    exp = Experiment.from_dict(experiment_points()[fname])
    assert rec["experiment"] == exp.to_dict()
    assert rec["metric"] == "serving"
    assert Result.from_dict(rec).to_dict() == rec
    assert rec["throughput"] > 0 and rec["offered"] > 0
    assert all(rec["latency"][k] is not None for k in LATENCY)
    if exp.replicas > 1:
        assert rec["replica_seeds"] == [0, 1, 2, 3]
        assert len(set(rec["per_replica"]["throughput"])) == 4
        assert sorted(rec["per_replica"]) == sorted(
            ("throughput", "offered", "dropped", "pool_stall") + LATENCY)
    else:
        assert rec["per_replica"] is None


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_serving_reference.py --capture [file ...]")
    capture(tuple(a for a in sys.argv[1:] if a != "--capture")
            or (SHORT,) + SERVING_FILES)
