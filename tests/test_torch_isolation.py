"""The port stands alone: it imports neither jax nor the reference
package, and its entry points never fall back to the CPU by themselves."""
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
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_to_run_on_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.api import Experiment, NetworkSpec, run
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
