"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

Both run in child processes, so that no pytest worker keeps their state:
the reference's ``run_cell`` with 8 forced host devices and a (2, 2, 2)
``make_test_mesh``, the port's with its own fake process group.  The two
children run side by side; every test below reads their records.

Checked:

* (i) every arch of ``ARCHS`` and every shape: the same ``status`` and
  ``reason`` (``supports``), and for the cells that run, the same
  ``n_active_params`` and ``model_flops`` (no compile needed);
* (ii) ``reduced(...)`` cells of one arch of each block kind (dense,
  hybrid, moe, mla, vision_super, enc/dec, mamba) at ``train_4k``,
  ``prefill_32k`` and ``decode_32k`` on the (2, 2, 2) mesh:
  ``memory_analysis.argument_bytes`` equal to the reference's (the
  per-device bytes of the same layout's arguments that the step reads),
  per-device FLOPs at the ratio to the reference's pinned in ``PINNED``
  within 1 % (PERF.md explains each ratio outside [0.95, 1.05]: the
  reference counts every (query, key) pair of causal attention, the
  port's kernel only the live ones; the port counts the scan kernels'
  float32 work), and the port's collective bytes by type pinned as its
  own regression figures (PERF.md compares them with GSPMD's); none on a
  (1, 1, 1) mesh;
* (iii) ``fabric.planner.plan_pod_axis`` runs on a port record, equal to
  the reference's planner on the same record;
* (iv) the full-width qwen3-1.7b ``train_4k`` cell on the 16 x 16
  production mesh (256 fake ranks) is ``ok``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

KINDS = {"dense": "qwen3-1.7b", "hybrid": "hymba-1.5b",
         "moe": "qwen3-moe-235b-a22b", "mla": "deepseek-v3-671b",
         "vision_super": "llama-3.2-vision-90b",
         "enc/dec": "seamless-m4t-medium", "mamba": "falcon-mamba-7b"}
SHAPES3 = ("train_4k", "prefill_32k", "decode_32k")
CELLS = [(a, s) for a in KINDS.values() for s in SHAPES3]
FLOPS_TOL = 0.01

# (port / reference per-device FLOPs, the port's collective bytes by type)
# of each reduced cell on the (2, 2, 2) mesh
PINNED = {
    ("qwen3-1.7b", "train_4k"): (0.5351, {
        "all-reduce": 1344963612, "all-gather": 141443072,
        "reduce-scatter": 68812800}),
    ("qwen3-1.7b", "prefill_32k"): (0.5087, {
        "all-reduce": 536903680, "all-gather": 33998848, "all-to-all": 4096}),
    ("qwen3-1.7b", "decode_32k"): (1.0000, {
        "all-reduce": 786432, "all-gather": 33812480, "all-to-all": 147456}),
    ("hymba-1.5b", "train_4k"): (1.0682, {
        "all-reduce": 2653984796, "all-gather": 661979136,
        "reduce-scatter": 69639168}),
    ("hymba-1.5b", "prefill_32k"): (1.0028, {
        "all-reduce": 973111296, "all-gather": 252323840, "all-to-all": 4096}),
    ("hymba-1.5b", "decode_32k"): (1.0000, {
        "all-reduce": 1343488, "all-gather": 21334016, "all-to-all": 278528}),
    ("qwen3-moe-235b-a22b", "train_4k"): (0.5264, {
        "all-reduce": 1345455132, "all-gather": 142032896,
        "reduce-scatter": 69206016}),
    ("qwen3-moe-235b-a22b", "prefill_32k"): (0.5066, {
        "all-reduce": 536903680, "all-gather": 34293760, "all-to-all": 4096}),
    ("qwen3-moe-235b-a22b", "decode_32k"): (1.0000, {
        "all-reduce": 565248, "all-gather": 34336768, "all-to-all": 16384}),
    ("deepseek-v3-671b", "train_4k"): (0.5389, {
        "all-reduce": 1982808092, "all-gather": 141971456,
        "reduce-scatter": 70021120}),
    ("deepseek-v3-671b", "prefill_32k"): (0.5074, {
        "all-reduce": 738230272, "all-gather": 34263040, "all-to-all": 4096}),
    ("deepseek-v3-671b", "decode_32k"): (1.0000, {
        "all-reduce": 630784, "all-gather": 34297856, "all-to-all": 163840}),
    ("llama-3.2-vision-90b", "train_4k"): (0.5797, {
        "all-reduce": 1613392964, "all-gather": 141443072,
        "reduce-scatter": 68812800}),
    ("llama-3.2-vision-90b", "prefill_32k"): (0.5163, {
        "all-reduce": 536903680, "all-gather": 33998848, "all-to-all": 4096}),
    ("llama-3.2-vision-90b", "decode_32k"): (1.0000, {
        "all-reduce": 753664, "all-gather": 17010688, "all-to-all": 180224}),
    ("seamless-m4t-medium", "train_4k"): (0.5364, {
        "all-reduce": 2153207836, "all-gather": 141885440,
        "reduce-scatter": 69107712}),
    ("seamless-m4t-medium", "prefill_32k"): (0.5089, {
        "all-reduce": 805470208, "all-gather": 34220032, "all-to-all": 4096}),
    ("seamless-m4t-medium", "decode_32k"): (1.0000, {
        "all-reduce": 557056, "all-gather": 33943552, "all-to-all": 212992}),
    ("falcon-mamba-7b", "train_4k"): (1.1130, {
        "all-reduce": 1042764828, "all-gather": 141148160,
        "reduce-scatter": 69261312}),
    ("falcon-mamba-7b", "prefill_32k"): (1.0893, {
        "all-reduce": 436240384, "all-gather": 33851392, "all-to-all": 4096}),
    ("falcon-mamba-7b", "decode_32k"): (1.0000, {
        "all-reduce": 708608, "all-gather": 176128, "all-to-all": 147456}),
}

_REF_CHILD = r"""
import dataclasses, json, os, sys
import jax
assert len(jax.devices()) == 8, jax.devices()
from repro.configs import ARCHS, SHAPES, get_config, reduced, supports
from repro.launch.dryrun import active_param_count, run_cell
from repro.launch.mesh import make_test_mesh
cells = json.loads(sys.argv[1])
mesh = make_test_mesh((2, 2, 2))
out = {"cells": {}, "all": {}}
for arch, shape in cells:
    red = reduced(get_config(arch))
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}
    out["cells"][arch + "/" + shape] = run_cell(arch, shape, False,
                                                mesh=mesh, overrides=ov)
for arch in ARCHS:
    cfg = get_config(arch)
    n = active_param_count(cfg)
    for shape, cell in SHAPES.items():
        ok, why = supports(cfg, shape)
        tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
        out["all"][arch + "/" + shape] = {
            "status": "ok" if ok else "skip", "reason": why,
            "n_active_params": n,
            "model_flops": (6 if cell.kind == "train" else 2) * n * tokens}
json.dump(out, open(sys.argv[2], "w"), default=float)
"""

_PORT_CHILD = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config, reduced
from repro_torch.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
out = {"cells": {}}
for arch, shape in cells:
    red = reduced(get_config(arch))
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}
    out["cells"][arch + "/" + shape] = run_cell(arch, shape, False,
                                                mesh=(2, 2, 2), overrides=ov)
red = reduced(get_config("qwen3-1.7b"))
ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}
out["one_rank"] = run_cell("qwen3-1.7b", "train_4k", False, mesh=(1, 1, 1),
                           overrides=ov)
out["full"] = run_cell("qwen3-1.7b", "train_4k", False)
json.dump(out, open(sys.argv[2], "w"), default=float)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Both children's records, run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cells = json.dumps(CELLS)
    path = str(ROOT / "src")
    ref_env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port_env = {"PYTHONPATH": path, "PATH": "/usr/bin:/bin"}
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", _REF_CHILD, cells, str(tmp / "ref.json")],
            cwd=ROOT, env=ref_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT_CHILD, cells,
             str(tmp / "port.json")], cwd=ROOT, env=port_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{name} child failed:\n{err[-4000:]}"
        out[name] = json.loads((tmp / f"{name}.json").read_text())
    return out


def _all_cells():
    from repro_torch.configs import ARCHS, SHAPES
    return [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", _all_cells())
def test_status_params_and_model_flops_equal_the_reference(records, arch,
                                                           shape):
    from repro_torch.configs import SHAPES, get_config, supports
    from repro_torch.launch.dryrun import (active_param_count, model_flops,
                                           run_cell)
    want = records["ref"]["all"][f"{arch}/{shape}"]
    cfg = get_config(arch)
    ok, why = supports(cfg, shape)
    assert ("ok" if ok else "skip", why) == (want["status"], want["reason"])
    if not ok:
        # a skipped cell is decided before any mesh is laid out
        rec = run_cell(arch, shape, False)
        assert rec == {"arch": arch, "shape": shape, "mesh": "16x16",
                       "status": "skip", "reason": want["reason"]}
        return
    assert active_param_count(cfg) == want["n_active_params"]
    assert model_flops(cfg, SHAPES[shape]) == want["model_flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference(records, arch, shape):
    got = records["port"]["cells"][f"{arch}/{shape}"]
    want = records["ref"]["cells"][f"{arch}/{shape}"]
    assert got["status"] == want["status"] == "ok"
    assert got["n_chips"] == want["n_chips"] == 8
    assert got["memory_analysis"]["argument_bytes"] == \
        want["memory_analysis"]["argument_bytes"]
    assert got["n_active_params"] == want["n_active_params"]
    assert got["model_flops"] == want["model_flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_ratio_to_the_reference_is_pinned(records, arch, shape):
    got = records["port"]["cells"][f"{arch}/{shape}"]["per_device"]
    want = records["ref"]["cells"][f"{arch}/{shape}"]["per_device"]
    ratio = got["flops"] / want["flops"]
    pinned = PINNED[(arch, shape)][0]
    assert abs(ratio - pinned) <= FLOPS_TOL * pinned, (ratio, pinned)
    assert got["gemm_flops"] <= got["flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collective_bytes_are_pinned(records, arch, shape):
    got = records["port"]["cells"][f"{arch}/{shape}"]["per_device"]
    assert got["collective_bytes"] == PINNED[(arch, shape)][1]
    assert set(got["collective_count"]) == set(got["collective_bytes"])
    assert all(n > 0 for n in got["collective_count"].values())


def test_one_rank_mesh_moves_nothing(records):
    one = records["port"]["one_rank"]
    mesh8 = records["port"]["cells"]["qwen3-1.7b/train_4k"]
    assert one["status"] == "ok" and one["n_chips"] == 1
    assert one["per_device"]["collective_bytes"] == {}
    assert one["roofline"]["collective_s"] == 0
    # the one rank does all the work the 8 share
    assert one["per_device"]["flops"] > 4 * mesh8["per_device"]["flops"]


@pytest.mark.parametrize("arch,shape", [("deepseek-v3-671b", "train_4k"),
                                        ("qwen3-moe-235b-a22b",
                                         "decode_32k")])
def test_plan_pod_axis_reads_a_port_record(records, arch, shape):
    from repro.fabric import planner as jax_planner
    from repro_torch.fabric.planner import plan_pod_axis
    rec = records["port"]["cells"][f"{arch}/{shape}"]
    compute = rec["roofline"]["compute_s"]
    got = plan_pod_axis(rec, n_pod_endpoints=512, compute_s=compute)
    want = jax_planner.plan_pod_axis(rec, 512, compute)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.recommended_fabric in ("mrls", "fat_tree", "dragonfly")
    assert got.est_comm_s[got.recommended_fabric] > 0


def test_full_width_cell_on_the_production_mesh(records):
    rec = records["port"]["full"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    pd = rec["per_device"]
    assert pd["kernel_launches"] == {"flash_attention": 56}
    assert set(pd["collective_bytes"]) >= {"all-reduce", "all-gather"}
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))


_LAYOUT_CHILD = r"""
import json
import torch
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_production_mesh, mesh_over_group
from repro_torch.models.common import ParamSpec, abstract_params
from repro_torch.parallel.sharding import Sharder
out = {}
fake_process_group(8)
try:
    make_production_mesh()
except RuntimeError as e:
    out["refused"] = str(e)
mesh, dm = mesh_over_group((2, 2, 2), ("pod", "data", "model"))
sh = Sharder(mesh, device_mesh=dm)
specs = {"w": ParamSpec((64, 6, 32), axes=("fsdp", "tp", None)),
         "kv": ParamSpec((64, 3, 32), axes=("fsdp", "tp", None)),
         "n": ParamSpec((64,), "float32", axes=(None,))}
params = abstract_params(specs, sh)
out["local"] = {k: list(v._local_tensor.shape) for k, v in params.items()}
out["placements"] = {k: [str(p) for p in v.placements]
                     for k, v in params.items()}
x = sh.constrain_safe(params["w"], "fsdp", None, None)
out["constrained"] = [str(p) for p in x.placements]
print(json.dumps(out))
"""


def test_layout_helpers_on_a_fake_mesh():
    """``make_production_mesh`` refuses a group of another size;
    ``abstract_params`` with a sharder places meta DTensors as
    ``param_shardings`` says (an axis that does not divide its dim
    replicated); ``constrain_safe`` redistributes a DTensor and leaves a
    plain tensor as it is."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import Sharder
    proc = subprocess.run([sys.executable, "-c", _LAYOUT_CHILD], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "needs 256 ranks, the process group has 8" in out["refused"]
    assert out["local"] == {"w": [16, 3, 32], "kv": [16, 3, 32], "n": [64]}
    assert out["placements"] == {"w": ["S(0)", "S(0)", "S(1)"],
                                 "kv": ["S(0)", "S(0)", "R"],
                                 "n": ["R", "R", "R"]}
    assert out["constrained"] == ["S(0)", "S(0)", "R"]
    sh = Sharder(make_test_mesh(device="cpu"))
    t = torch.zeros(4, 8)
    assert sh.constrain(t, "dp", None) is t
    assert sh.constrain_safe(t, "dp", "tp") is t
