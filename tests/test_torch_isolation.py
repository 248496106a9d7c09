"""The port stands alone: it imports neither jax (nor ``ml_dtypes``,
which comes with jax) nor the reference package, and its entry points
never fall back to the CPU by themselves."""
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
# the workload-program layer is among the modules walked
missing = sorted({"repro_torch.core.collectives", "repro_torch.workloads.ir",
                  "repro_torch.workloads.compile",
                  "repro_torch.workloads.programs",
                  "repro_torch.serving", "repro_torch.serving.spec",
                  "repro_torch.serving.bridge", "repro_torch.serving.sweep",
                  "repro_torch.simulator.arrivals",
                  "repro_torch.checkpointing",
                  "repro_torch.checkpointing.checkpoint",
                  "repro_torch.runtime.fault_tolerance",
                  "repro_torch.runtime.resilient",
                  "repro_torch.runtime.supervisor",
                  "repro_torch.api.resume",
                  "repro_torch.api.memory", "repro_torch.api.admission",
                  "repro_torch.search", "repro_torch.search.spec",
                  "repro_torch.search.space", "repro_torch.search.pareto",
                  "repro_torch.search.loop", "repro_torch.search.cli",
                  "repro_torch.fabric",
                  "repro_torch.fabric.planner",
                  "repro_torch.parallel", "repro_torch.parallel.sharding",
                  "repro_torch.launch.mesh",
                  "repro_torch.launch.dryrun",
                  "repro_torch.launch.op_stats",
                  "repro_torch.kernels._work",
                  "repro_torch.configs.falcon_mamba_7b",
                  "repro_torch.configs.base",
                  "repro_torch.configs.nemotron_4_15b",
                  "repro_torch.configs.starcoder2_15b",
                  "repro_torch.configs.command_r_plus_104b",
                  "repro_torch.configs.deepseek_v3_671b",
                  "repro_torch.configs.llama_3_2_vision_90b",
                  "repro_torch.configs.seamless_m4t_medium",
                  "repro_torch.models.moe",
                  "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                  "repro_torch.optim.compression",
                  "repro_torch.launch.steps",
                  "repro_torch.launch.train",
                  "repro_torch.kernels.selective_scan.ops",
                  "repro_torch.kernels.selective_scan.kernel"} - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_DRYRUN = """
import sys
import torch.distributed as dist
import repro_torch.launch.dryrun, repro_torch.launch.mesh
import repro_torch.launch.op_stats
from repro_torch.launch.mesh import make_production_mesh
print(dist.is_initialized())
try:
    make_production_mesh()
except RuntimeError as e:
    print(e)
print(dist.is_initialized())
"""


def test_dry_run_modules_initialize_no_process_group():
    """Importing the dry run, the mesh and the accountant sets up no
    process group; the production mesh refuses to stand in for one."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_DRYRUN],
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == lines[-1] == "False"
    assert "needs a process group of 256 ranks" in lines[1]


def test_entry_points_refuse_to_run_on_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.api import Experiment, NetworkSpec, WorkloadSpec, run
    from repro_torch.workloads import compile_program, rabenseifner_program
    from repro_torch.core import build_tables, exact_metrics, mrls
    from repro_torch.simulator.engine import SimConfig, Simulator
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tables(mrls(14, 3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exact_metrics(mrls(14, 3, 3))
    tables = build_tables(mrls(14, 3, 3), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(tables, SimConfig())
    exp = Experiment(NetworkSpec("mrls", {"n_leaves": 14, "u": 3, "d": 3}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(exp)
    # the workload programs: run on a collective, and the simulator that
    # run_program is called on, need the card unless asked for the CPU
    for workload in (WorkloadSpec("allreduce", ranks=16, vec_packets=4),
                     WorkloadSpec("all2all", rounds=2, schedule="window",
                                  window=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(dataclasses.replace(exp, workload=workload))
    sim = Simulator(tables, SimConfig(), device="cpu")
    cp = compile_program(rabenseifner_program(sim.S, 16, 4))
    assert sim.run_program(cp, max_slots=2000)["completed"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(tables, SimConfig()).run_program(cp)


def test_serving_entry_points_refuse_to_run_on_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import json

    from repro_torch.api.__main__ import main as cli_main
    from repro_torch.serving import ServingSpec, serve_sweep
    spec = ServingSpec.from_dict({
        "network": {"family": "mrls",
                    "params": {"n_leaves": 14, "u": 3, "d": 3}},
        "loads": [0.5], "warm": 2, "measure": 2})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sweep(spec)
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"servings": [spec.to_dict()]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["serve-sweep", str(path)])
    assert serve_sweep(spec, device="cpu")["points"][0]["offered"] > 0


def test_failure_entry_points_refuse_to_run_on_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import json

    from repro_torch.api import DegradeSpec, Experiment, degrade_sweep, run
    from repro_torch.api.__main__ import main as cli_main
    base = {"network": {"family": "mrls",
                        "params": {"n_leaves": 14, "u": 3, "d": 3}},
            "route": {"policy": "degraded", "max_hops": 10, "pool": 4096},
            "warm": 2, "measure": 2}
    spec = DegradeSpec.from_dict({"base": base, "rates": [0.0, 0.1],
                                  "down_slot": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        degrade_sweep(spec)
    path = tmp_path / "degrade.json"
    path.write_text(json.dumps({"sweeps": [spec.to_dict()]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["degrade", str(path)])
    failing = dict(base["network"], failures={"events": [
        {"kind": "link", "id": 0, "down_slot": 1}]})
    exp = Experiment.from_dict(dict(base, network=failing))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(exp)
    assert run(exp, device="cpu").metric == "resilience"
    assert degrade_sweep(spec, device="cpu")["points"][1]["n_links_down"] > 0


def test_resumable_entry_points_refuse_to_run_on_the_cpu_by_default(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.api import Experiment, resume, run_resumable
    from repro_torch.api.__main__ import main as cli_main
    spec = ROOT / "examples" / "specs" / "tiny_mrls_a2a.json"
    exp = Experiment.from_json(spec.read_text())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_resumable(exp, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["run", str(spec), "--ckpt-dir", str(tmp_path / "b")])
    done = run_resumable(exp, str(tmp_path / "c"), device="cpu")
    assert done.completed
    # a finished directory is reported, not run, so it needs no device
    assert resume(str(tmp_path / "c")) == done


def test_search_and_estimate_refuse_to_run_on_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import json

    from repro_torch.api import check_admission, device_peak_bytes
    from repro_torch.api.__main__ import main as cli_main
    from repro_torch.search import SearchSpec, search
    spec = SearchSpec(endpoints=32, families=("mrls",), radix=(8,),
                      f=(1.0,), vcs=(2,), budget=1, screen_warm=2,
                      screen_measure=2, warm=2, measure=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search(spec)
    path = tmp_path / "search.json"
    path.write_text(json.dumps({"search": spec.to_dict()}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["search", str(path), "--pareto-out", ""])
    exp_path = ROOT / "examples" / "specs" / "tiny_mrls.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["estimate", str(exp_path)])
    from repro_torch.api import Experiment
    exp = Experiment.from_json(exp_path.read_text())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_admission(exp)
    # pricing the card needs no card
    assert device_peak_bytes(exp) > device_peak_bytes(exp, "cpu")
    assert search(spec, device="cpu")["n_candidates"] == 1


def test_placement_entry_points_refuse_to_run_on_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import Sharder, make_sim_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sim_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sharder.for_simulator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_mesh()
    assert make_sim_mesh(2, device="cpu").devices == (torch.device("cpu"),) * 2


def test_training_entry_points_refuse_to_run_on_the_cpu_by_default(
        tmp_path):
    """The training path's entry points need the card unless asked for
    the CPU: the data pipeline, the optimizer state, ``build_training``
    and ``python -m repro_torch.launch.train``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import build_training
    from repro_torch.models.model import build_specs
    from repro_torch.optim.adamw import AdamWConfig, init_opt
    cfg = reduced(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(DataConfig(cfg.vocab, 8, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_opt(build_specs(cfg), AdamWConfig())
    data = SyntheticLM(DataConfig(cfg.vocab, 8, 1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_training(cfg, AdamWConfig(), str(tmp_path), data)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--steps", "1", "--seq", "8",
         "--global-batch", "1", "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and proc.stdout == ""
    assert not (tmp_path / "ckpt").exists()
