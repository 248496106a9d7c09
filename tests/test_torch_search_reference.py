"""The JAX reference's design-space search record that ``chip_smoke.py``
holds the port to on the card (phase 19).

``torch_search_1k_uniform_cut.json`` holds ``search_1k_uniform`` of
``examples/specs/search_1k.json`` (1,024 endpoints; ``mrls`` /
``jellyfish`` / ``fat_tree``; radix 16 / 24 / 32; f 1 / 2; ``polarized``
/ ``ugal``; 4 VCs; uniform load 1.0; random strategy, seed 7) cut for
time: 6 candidates of 14, screen 10 + 30 and full 30 + 60 slots (of 30 +
60 and 100 + 200), and a 16 MiB ``mem_budget_mib`` that prunes the one
draw above it (``fat_tree.r24.f2.ugal.v4``, 3,456 endpoints).  The file
holds the cut ``SearchSpec`` and ``repro.search.search``'s record.

The tests check that the file records its cut spec, that the port prices
every candidate as the reference does, and replay the search through the
port on the CPU (about 35 s on one thread); ``chip_smoke.py`` runs it on
the card.  Each compares the record field for field, except
``predicted_device_bytes``, the port's key in place of the reference's
``predicted_rss_bytes``.

Regenerate the file with ``PYTHONPATH=src python
tests/test_torch_search_reference.py --capture`` (jax's partitionable
threefry stream).  Tolerance: zero.
"""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "torch_search_1k_uniform_cut.json"
SPEC_FILE = ROOT / "examples" / "specs" / "search_1k.json"

# the cuts of search_1k_uniform, each recorded in the golden's spec
CUT = {"budget": 6, "screen_warm": 10, "screen_measure": 30, "warm": 30,
       "measure": 60, "mem_budget_mib": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut_spec() -> dict:
    """``search_1k_uniform``'s spec dict with the cuts applied."""
    doc = json.loads(SPEC_FILE.read_text())
    spec, = [s for s in doc["searches"] if s["name"] == "search_1k_uniform"]
    return {**spec, **CUT}


def reference_record() -> dict:
    from repro.search import SearchSpec, search
    spec = SearchSpec.from_dict(cut_spec())
    return {"spec": spec.to_dict(), "record": search(spec)}


def capture() -> None:
    GOLDEN.write_text(json.dumps(reference_record(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", flush=True)


def _load() -> dict:
    return json.loads(GOLDEN.read_text())


def test_golden_records_its_cut_spec():
    from repro_torch.search import SearchSpec
    g = _load()
    spec = SearchSpec.from_dict(cut_spec())
    assert g["spec"] == spec.to_dict()
    assert g["record"]["spec"] == spec.to_dict()
    for k, v in CUT.items():
        assert g["spec"][k] == v
    full = SearchSpec.from_dict(json.loads(SPEC_FILE.read_text())
                                ["searches"][0])
    assert (full.budget, full.screen_warm, full.screen_measure, full.warm,
            full.measure, full.mem_budget_mib) == (14, 30, 60, 100, 200,
                                                    None)


def test_golden_prunes_one_draw_and_screens_five():
    rec = _load()["record"]
    assert rec["n_candidates"] == 6 and rec["space_size"] == 36
    assert rec["counts"]["invalid"] == 0 and rec["counts"]["pruned"] == 1
    assert rec["counts"]["screened"] + rec["counts"]["full"] == 5
    pruned, = [c for c in rec["candidates"] if c["status"] == "pruned"]
    assert pruned["label"] == "fat_tree.r24.f2.ugal.v4"
    assert pruned["n_endpoints"] == 3456
    assert pruned["est_peak_bytes"] > 16 << 20
    for c in rec["candidates"]:
        if c["status"] != "pruned":
            assert c["est_peak_bytes"] <= 16 << 20
            assert "predicted_rss_bytes" in c
            assert c["screen"]["throughput"] > 0
    assert rec["frontier"]


def test_port_prices_the_golden_candidates_as_the_reference():
    """The port's ``_price`` gives each candidate's record the
    reference's fields (``predicted_device_bytes`` in place of
    ``predicted_rss_bytes``), with no simulator built."""
    from repro_torch.search import SearchSpec
    from repro_torch.search.loop import _price
    from repro_torch.search.space import Candidate
    spec = SearchSpec.from_dict(cut_spec())
    skip = ("screen", "full", "throughput", "objective", "dominated",
            "status", "predicted_rss_bytes")
    for want in _load()["record"]["candidates"]:
        got = _price(spec, Candidate.from_dict(want), want["id"],
                     device="cpu")
        status = got.pop("status")
        assert status == ("pruned" if want["status"] == "pruned"
                          else "admitted")
        got.pop("_exp", None)
        if status == "admitted":
            assert got.pop("predicted_device_bytes") > 0
        assert json.loads(json.dumps(got)) == {
            k: v for k, v in want.items() if k not in skip}


def test_cut_search_through_the_port_on_the_cpu():
    from repro_torch.search import SearchSpec, search
    g = _load()
    rec = json.loads(json.dumps(search(SearchSpec.from_dict(g["spec"]),
                                       device="cpu")))
    want = g["record"]
    for got_c, want_c in zip(rec["candidates"], want["candidates"]):
        assert ("predicted_device_bytes" in got_c) == (
            "predicted_rss_bytes" in want_c)
        got_c.pop("predicted_device_bytes", None)
    want = dict(want, candidates=[
        {k: v for k, v in c.items() if k != "predicted_rss_bytes"}
        for c in want["candidates"]])
    assert rec == want


if __name__ == "__main__":
    if "--capture" not in sys.argv:
        sys.exit("usage: PYTHONPATH=src python "
                 "tests/test_torch_search_reference.py --capture")
    capture()
