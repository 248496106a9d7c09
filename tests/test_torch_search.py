"""The port's design-space search against the reference's.

``SearchSpec`` dicts and messages, the designers, ``candidate_experiment``
and the Pareto functions equal the reference's; ``search`` on
``examples/specs/tiny_search.json`` (random, with pruning) and on an
evolutionary variant, on the CPU, gives the reference's record field for
field except one key (``predicted_device_bytes`` in place of
``predicted_rss_bytes``); the CLI's ``search --device cpu`` gives
``python -m repro.api search``'s records, Pareto artifact and summary.
Tolerance: zero.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.search as jax_search
import repro_torch.search as port_search
from repro.api.cli import main as jax_cli_main
from repro_torch.api.__main__ import main as cli_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_SPEC = ROOT / "examples" / "specs" / "tiny_search.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny() -> dict:
    return json.loads(TINY_SPEC.read_text())["search"]


def _plain(record) -> dict:
    """A record as its JSON text reads back."""
    return json.loads(json.dumps(record))


def _renamed(port_rec: dict, ref_rec: dict) -> tuple:
    """Both records with the one documented difference taken out: the
    port's ``predicted_device_bytes`` and the reference's
    ``predicted_rss_bytes``, each present on the same candidates."""
    port_rec, ref_rec = _plain(port_rec), _plain(ref_rec)
    for p, r in zip(port_rec["candidates"], ref_rec["candidates"]):
        assert ("predicted_device_bytes" in p) == ("predicted_rss_bytes"
                                                   in r)
        if "predicted_device_bytes" in p:
            assert p.pop("predicted_device_bytes") > 0
            r.pop("predicted_rss_bytes")
    return port_rec, ref_rec


# ---------------------------------------------------------------------- #
# specs, designers, Pareto
# ---------------------------------------------------------------------- #
SPECS = [
    dict(endpoints=64),
    dict(endpoints=64, radix=(8, 16), f=(1.0, 2.0), vcs=(2, 8), budget=4,
         mem_budget_mib=0.5, strategy="evolutionary", name="rt"),
    dict(endpoints=64, families="mrls", radix=[8], f=2, vcs=[4]),
    dict(endpoints=1024, policies=["polarized", "ugal"], replicas=3,
         workload={"pattern": "all2all", "rounds": 4}, max_slots=500,
         route={"policy": "ksp", "max_hops": 9}),
]


@pytest.mark.parametrize("kw", SPECS)
def test_searchspec_dicts_equal_the_reference(kw):
    ref = jax_search.SearchSpec.from_dict(kw)
    got = port_search.SearchSpec.from_dict(kw)
    assert got.to_dict() == ref.to_dict()
    assert got.to_json() == ref.to_json()
    assert port_search.SearchSpec.from_json(got.to_json()) == got
    assert hash(port_search.SearchSpec.from_dict(got.to_dict())) == hash(got)
    assert (got.label(), got.mem_budget_bytes()) == (ref.label(),
                                                     ref.mem_budget_bytes())
    assert port_search.space_size(got) == jax_search.space.space_size(ref)
    assert (port_search.axis_values(got)
            == jax_search.space.axis_values(ref))


def test_spec_files_load_as_the_reference_loads_them():
    for path in (TINY_SPEC, ROOT / "examples" / "specs" / "search_1k.json"):
        doc = json.loads(path.read_text())
        for d in doc.get("searches", [doc.get("search")]):
            assert (port_search.SearchSpec.from_dict(d).to_dict()
                    == jax_search.SearchSpec.from_dict(d).to_dict())


@pytest.mark.parametrize("kw", [
    {"endpoints": 2},
    {"endpoints": 64, "objective": "latency"},
    {"endpoints": 64, "strategy": "anneal"},
    {"endpoints": 64, "policies": ("shortest",)},
    {"endpoints": 64, "budget": 0},
    {"endpoints": 64, "survivors": 0.0},
    {"endpoints": 64, "survivors": 1.5},
    {"endpoints": 64, "screen_measure": 0},
    {"endpoints": 64, "max_slots": 0},
    {"endpoints": 64, "replicas": 0},
    {"endpoints": 64, "mem_budget_mib": -1},
    {"endpoints": 64, "families": ()},
])
def test_searchspec_messages_equal_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        jax_search.SearchSpec(**kw)
    with pytest.raises(ValueError) as got:
        port_search.SearchSpec(**kw)
    assert str(got.value) == str(ref.value)


def _design(pkg, cand, endpoints, seed):
    try:
        return ("ok", pkg.design_network(cand, endpoints, seed=seed)
                .to_dict())
    except pkg.DesignError as e:
        return ("design", str(e))
    except KeyError as e:
        return ("key", str(e))


@pytest.mark.parametrize("endpoints", [32, 64, 1024, 3000])
def test_designers_equal_the_reference(endpoints):
    assert (port_search.designer_families()
            == jax_search.designer_families())
    for family in ("mrls", "jellyfish", "fat_tree", "torus"):
        for radix in (3, 4, 8, 15, 16, 24, 32, 36):
            for f in (0.5, 1.0, 2.0, 3.0, 10.0):
                args = (family, radix, f, "polarized", 4)
                got = _design(port_search, port_search.Candidate(*args),
                              endpoints, 7)
                ref = _design(jax_search, jax_search.Candidate(*args),
                              endpoints, 7)
                assert got == ref, (args, endpoints)


def test_candidates_and_stages_equal_the_reference():
    d = dict(family="mrls", radix=16, f=1.0, policy="minimal_adaptive",
             vcs=2)
    pc, rc = port_search.Candidate(**d), jax_search.Candidate(**d)
    assert pc.to_dict() == rc.to_dict() and pc.label() == rc.label()
    assert port_search.Candidate.from_dict(
        {**d, "radix": "16", "f": 1}) == pc
    spec = dict(endpoints=64, screen_warm=5, screen_measure=10, warm=50,
                measure=100, replicas=2, seed=3, name="st")
    for stage in ("screen", "full"):
        got = port_search.candidate_experiment(
            port_search.SearchSpec(**spec), pc,
            port_search.design_network(pc, 64), stage=stage)
        ref = jax_search.candidate_experiment(
            jax_search.SearchSpec(**spec), rc,
            jax_search.design_network(rc, 64), stage=stage)
        assert got.to_dict() == ref.to_dict()


def test_register_designer_idempotent_and_conflicting():
    def designer(endpoints, radix, f, seed):
        return {"radix": radix, "h": 1}
    port_search.register_designer("_tmp_fam", designer)
    port_search.register_designer("_tmp_fam", designer)   # no-op
    with pytest.raises(ValueError, match="overwrite=True"):
        port_search.register_designer("_tmp_fam", lambda *a: {})
    port_search.register_designer("_tmp_fam", designer, overwrite=True)
    assert "_tmp_fam" in port_search.designer_families()
    net = port_search.design_network(
        port_search.Candidate("_tmp_fam", 8, 1.0, "polarized", 4), 64)
    assert net.to_dict() == {"family": "_tmp_fam",
                             "params": {"h": 1, "radix": 8}}
    from repro_torch.search import space
    del space._DESIGNERS["_tmp_fam"]


@pytest.mark.parametrize("seed", range(6))
def test_pareto_functions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 24))
    # a coarse grid makes ties and duplicate points
    pts = [{"throughput": float(rng.integers(0, 6)) / 5,
            "cost_links": float(rng.integers(1, 6)) / 2} for _ in range(n)]
    ids = [int(i) for i in rng.permutation(100)[:n]]
    assert (port_search.dominated_flags(pts)
            == jax_search.dominated_flags(pts))
    assert port_search.frontier_ids(pts) == jax_search.frontier_ids(pts)
    assert (port_search.frontier_ids(pts, ids)
            == jax_search.frontier_ids(pts, ids))


def test_promotion_equals_the_reference():
    from repro.search.loop import _promote as ref_promote
    from repro_torch.search.loop import _promote
    rng = np.random.default_rng(5)
    for survivors in (0.25, 0.5, 1.0):
        screened = [{"id": i, "cost_links": float(rng.integers(1, 5)),
                     "screen": {"throughput": float(rng.integers(0, 4)) / 4,
                                "objective": float(rng.random())}}
                    for i in range(9)]
        a = _promote(port_search.SearchSpec(endpoints=64,
                                            survivors=survivors), screened)
        b = ref_promote(jax_search.SearchSpec(endpoints=64,
                                              survivors=survivors), screened)
        assert [[r["id"] for r in x] for x in a] == \
            [[r["id"] for r in x] for x in b]


def test_search_rejects_non_all2all_collectives():
    spec = port_search.SearchSpec(endpoints=32, workload={
        "pattern": "allreduce", "ranks": 8, "vec_packets": 4})
    with pytest.raises(ValueError, match="all2all"):
        port_search.search(spec, device="cpu")


# ---------------------------------------------------------------------- #
# the search loop against the reference, on the CPU
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_cli(tmp_path_factory):
    """``python -m repro.api search tiny_search.json``: its records, its
    Pareto artifact and its printed summary."""
    import contextlib
    import io
    d = tmp_path_factory.mktemp("ref")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli_main(["search", str(TINY_SPEC), "--out",
                             str(d / "records.json"), "--pareto-out",
                             str(d / "pareto.json")]) == 0
    return {"records": json.loads((d / "records.json").read_text()),
            "pareto": json.loads((d / "pareto.json").read_text()),
            "stdout": out.getvalue()}


def test_tiny_search_equals_the_reference(reference_cli):
    spec = port_search.SearchSpec.from_dict(_tiny())
    rec = port_search.search(spec, device="cpu")
    ref, = reference_cli["records"]
    got, want = _renamed(rec, ref)
    assert got == want
    assert rec["counts"]["pruned"] >= 1 and rec["counts"]["invalid"] >= 1
    assert rec["counts"]["full"] >= 1 and rec["frontier"]


def test_evolutionary_search_equals_the_reference():
    kw = {**_tiny(), "strategy": "evolutionary", "budget": 6,
          "mem_budget_mib": None, "families": ["mrls", "jellyfish"],
          "radix": [8], "screen_warm": 5, "screen_measure": 10, "warm": 10,
          "measure": 20, "seed": 2}
    got = port_search.search_many([port_search.SearchSpec.from_dict(kw)],
                                  device="cpu")
    ref = jax_search.search_many([jax_search.SearchSpec.from_dict(kw)])
    assert len(got) == len(ref) == 1
    got, want = _renamed(got[0], ref[0])
    assert got == want
    assert got["strategy"] == "evolutionary" and got["counts"]["full"] >= 1


def test_mem_budget_prunes_before_building(monkeypatch):
    import repro_torch.api.runner as runner

    def boom(*a, **kw):
        raise AssertionError("a pruned candidate reached the simulator")
    monkeypatch.setattr(runner, "_make_simulator", boom)
    spec = port_search.SearchSpec.from_dict({**_tiny(),
                                             "mem_budget_mib": 0.001})
    rec = port_search.search(spec, device="cpu")
    assert rec["counts"]["pruned"] == rec["n_candidates"] - rec["counts"][
        "invalid"] > 0
    assert rec["frontier"] == []


def test_admission_prunes_on_the_device_budget(monkeypatch):
    """A candidate within ``mem_budget_mib`` but over the device's budget
    is pruned by the admission gate, with its message."""
    from repro_torch.api import admission
    monkeypatch.setattr(admission, "host_ram_bytes", lambda: 1024)
    admission._memo.clear()
    spec = port_search.SearchSpec.from_dict({**_tiny(), "budget": 3})
    rec = port_search.search(spec, device="cpu")
    admission._memo.clear()
    pruned = [c for c in rec["candidates"] if c["status"] == "pruned"]
    assert pruned and rec["counts"]["screened"] == rec["counts"]["full"] == 0
    assert any(c["reason"].startswith("admission refused: experiment ")
               for c in pruned)


def test_cli_search_equals_the_reference(tmp_path, capsys, reference_cli):
    out, pareto = tmp_path / "records.json", tmp_path / "pareto.json"
    assert cli_main(["search", str(TINY_SPEC), "--device", "cpu", "--out",
                     str(out), "--pareto-out", str(pareto)]) == 0
    stdout = capsys.readouterr().out
    got = json.loads(out.read_text())
    ref = reference_cli["records"]
    assert len(got) == len(ref) == 1
    a, b = _renamed(got[0], ref[0])
    assert a == b
    a, b = _renamed(json.loads(pareto.read_text()), reference_cli["pareto"])
    assert a == b
    # the summary lines, less the file paths of the last two
    want = reference_cli["stdout"].splitlines()
    lines = stdout.splitlines()
    assert lines[:-2] == want[:-2]
    assert lines[-2] == f"wrote Pareto artifact to {pareto}"
    assert lines[-1] == f"wrote 1 search record(s) to {out}"


def test_cli_search_overrides(tmp_path, capsys):
    spec = tmp_path / "s.json"
    spec.write_text(json.dumps({"searches": [
        {**_tiny(), "budget": 2, "families": ["mrls"], "radix": [8],
         "mem_budget_mib": None, "name": "a"}]}))
    out = tmp_path / "r.json"
    assert cli_main(["search", str(spec), "--device", "cpu", "--seed", "4",
                     "--replicas", "2", "--pareto-out", "", "--out",
                     str(out)]) == 0
    assert "Pareto artifact" not in capsys.readouterr().out
    rec, = json.loads(out.read_text())
    assert (rec["spec"]["seed"], rec["spec"]["replicas"]) == (4, 2)
    want = dataclasses.replace(
        jax_search.SearchSpec.from_dict({**_tiny(), "budget": 2,
                                         "families": ["mrls"],
                                         "radix": [8],
                                         "mem_budget_mib": None,
                                         "name": "a"}),
        seed=4, replicas=2)
    assert rec["spec"] == want.to_dict()
