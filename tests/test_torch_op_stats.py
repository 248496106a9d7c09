"""The port's per-device cost accountant (``repro_torch.launch.op_stats``)
against the reference's ``repro.launch.hlo_stats``.

Checked:

* the port of ``tests/test_system.py::test_hlo_stats_counts_loop_trips``:
  ten steps of ``tanh(c @ w_i)`` at [128, 256] x [256, 256] count
  ``10 * 2 * 128 * 256 * 256`` FLOPs exactly, equal to the reference's
  ``hlo_stats.analyze`` of the same scanned function (which multiplies
  the loop body by its trip count), and ``cost_analysis_dict`` gives the
  same total;
* the bytes of single operations: operands and result of an add, none
  for a view or an allocation, the live-bytes peak;
* the work a hand kernel records on ``meta`` tensors
  (``kernels._work``): the attention forward's and the scan's, with the
  counts their benches divide for the bound;
* functional collectives on a fake 8-rank mesh (in a child process, so
  that no process group stays in the test worker): all-reduce,
  all-gather, reduce-scatter and all-to-all by type and operand bytes,
  nothing for a group of one rank, and DTensor's move of a split from
  one dim to another counted as the all-to-all it stands for.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(c, w):
    x = c
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def test_loop_of_products_counts_every_step_like_hlo_stats():
    import jax
    import jax.numpy as jnp
    from repro.launch import hlo_stats
    from repro_torch.launch.op_stats import OpStats, cost_analysis_dict
    want = 10 * 2 * 128 * 256 * 256
    c = torch.empty(128, 256, device="meta")
    w = torch.empty(10, 256, 256, device="meta")
    with OpStats() as st:
        _loop(c, w)
    assert st.flops == want and st.gemm_flops == want
    assert dict(st.flops_by_op) == {"aten.mm": want}
    assert cost_analysis_dict(_loop, c, w)["flops"] == want

    def f(x, wj):
        def body(cc, wi):
            return jnp.tanh(cc @ wi), None
        return jax.lax.scan(body, x, wj)[0]
    comp = jax.jit(f).lower(jax.ShapeDtypeStruct((128, 256), jnp.float32),
                            jax.ShapeDtypeStruct((10, 256, 256),
                                                 jnp.float32)).compile()
    assert hlo_stats.analyze(comp.as_text())["flops"] == st.flops


def test_bytes_of_single_operations():
    from repro_torch.launch.op_stats import OpStats
    a = torch.empty(128, 256, device="meta")
    b = torch.empty(128, 256, device="meta", dtype=torch.bfloat16)
    with OpStats() as st:
        a.t()                                   # a view: nothing moves
        e = torch.empty(64, 64, device="meta")  # storage, no data written
        y = a + b                               # float32 out
        del e
        z = a * 2                               # e's bytes are free again
    assert st.bytes == 128 * 256 * (4 + 2 + 4) + 128 * 256 * (4 + 4)
    assert st.n_ops == 4 and st.flops == 0
    r = st.result()
    assert r["peak_live_bytes"] == 2 * 128 * 256 * 4
    assert r["collective_total"] == 0 and r["collective_bytes"] == {}
    assert y.shape == z.shape == (128, 256)


def test_hand_kernels_record_their_work_on_meta():
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.kernels.flash_attention.bench import bound_ms
    from repro_torch.kernels.flash_attention.ref import (attention_work,
                                                         live_pairs)
    from repro_torch.kernels.selective_scan import selective_scan_op
    from repro_torch.kernels.selective_scan.ref import (scan_bwd_work,
                                                        scan_work)
    from repro_torch.launch.op_stats import OpStats
    for sq, skv, win, causal in [(77, 333, None, True), (1000, 1000, 300,
                                                         True),
                                 (130, 130, 5, True), (5, 9, None, False),
                                 (64, 64, 0, True)]:
        qpos = np.arange(sq)[:, None] + skv - sq
        kpos = np.arange(skv)[None, :]
        mask = (kpos <= qpos) if causal else np.ones((sq, skv), bool)
        if win is not None:
            mask &= kpos > qpos - (win + 1)
        assert live_pairs(sq, skv, win, causal) == int(mask.sum())
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, 64, 8, 32, **m, requires_grad=True)
    k = torch.empty(2, 64, 2, 32, **m, requires_grad=True)
    with OpStats() as st:
        o = flash_attention_op(q, k, k, 16)
    ops, n_bytes = attention_work(2, 64, 64, 8, 2, 32, 16)
    assert o.shape == (2, 64, 8, 32) and o.device.type == "meta"
    assert st.flops_by_op["flash_attention"] == ops
    assert dict(st.kernel_launches) == {"flash_attention": 1}
    assert ops == 2 * 64 * 2 * 8 * live_pairs(64, 64, 16)
    t_ms, _ = bound_ms(2, 64, 64, 8, 2, 32, 16)
    assert t_ms == max(n_bytes / 3.35e9, ops / 989e9)
    f = dict(device="meta", dtype=torch.float32)
    u = torch.empty(2, 48, 40, **f, requires_grad=True)
    A = torch.empty(40, 16, **f)
    Bc = torch.empty(2, 48, 16, **f)
    h0 = torch.empty(2, 40, 16, **f)
    with OpStats() as st:
        y, h = selective_scan_op(u, u, A, Bc, Bc, h0)
        y.sum().backward()
    fwd, bwd = scan_work(2, 48, 40, 16), scan_bwd_work(2, 48, 40, 16)
    assert y.shape == (2, 48, 40) and h.shape == (2, 40, 16)
    assert st.flops_by_op["selective_scan"] == fwd["flops"] == 7 * 2 * 48 \
        * 40 * 16
    assert st.flops_by_op["selective_scan_bwd"] == bwd["flops"]
    assert dict(st.kernel_launches) == {"selective_scan": 1,
                                        "selective_scan_bwd": 1}
    assert u.grad.shape == u.shape


_COLLECTIVES = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.op_stats import OpStats
fake_process_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
x = torch.empty(16, 32, device="meta", dtype=torch.bfloat16)
out = {}
with OpStats() as st:
    funcol.all_reduce(x, "sum", (mesh, 1))
    funcol.all_gather_tensor(x, 0, (mesh, 1))
    funcol.reduce_scatter_tensor(x, "sum", 0, (mesh, 1))
    funcol.all_to_all_single(x, None, None, (mesh, 0))
    funcol.all_reduce(x, "sum", dist.group.WORLD)
out["funcol"] = st.result()
t = DTensor.from_local(torch.empty(4, 32, device="meta"), mesh,
                       [Shard(0), Shard(0)], run_check=False)
with OpStats() as st:
    t.redistribute(mesh, [Shard(0), Shard(1)])
out["dtensor"] = st.result()
dist.destroy_process_group()
fake_process_group(8)
one = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
with OpStats() as st:
    funcol.all_reduce(x, "sum", (one, 1))
out["one"] = st.result()
print(json.dumps(out))
"""


def test_functional_collectives_by_type_on_a_fake_mesh():
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVES], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    x = 16 * 32 * 2
    fc = out["funcol"]
    assert fc["collective_bytes"] == {"all-reduce": 2 * x, "all-gather": x,
                                      "reduce-scatter": x, "all-to-all": x}
    assert fc["collective_count"] == {"all-reduce": 2, "all-gather": 1,
                                      "reduce-scatter": 1, "all-to-all": 1}
    assert fc["collective_total"] == 5 * x
    assert fc["bytes"] == 2 * 5 * x and fc["flops"] == 0
    # Shard(0) to Shard(1) over the 4 ranks of "model": the local [4, 32]
    # float32 shard goes through one all-to-all
    dt = out["dtensor"]
    assert dt["collective_bytes"] == {"all-to-all": 4 * 32 * 4}
    assert dt["collective_count"] == {"all-to-all": 1}
    assert out["one"]["collective_bytes"] == {}
