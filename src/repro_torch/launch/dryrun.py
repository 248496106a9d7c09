"""Multi-pod dry run: lay out and trace every (arch x shape x mesh) cell.

The port of the reference's ``launch/dryrun.py``.  For each cell it lays
the port's model out on 256 or 512 ranks of a fake process group
(``torch.distributed``'s ``fake`` backend: one process stands for rank
0, and collectives move nothing) through DTensor, and runs the cell's
step once on ``meta`` tensors (shapes, no data) under the accountant of
``launch.op_stats``.  That proves the layout coherent (every operation
has a sharding rule or runs on local shards, every redistribution is
legal) and gives the roofline terms, per device:

  compute    = flops / peak_flops    (989 TFLOP/s dense bf16, H100 SXM)
  memory     = bytes / hbm_bw        (3.35 TB/s HBM3, H100 SXM)
  collective = collective_bytes / link_bw  (50 GB/s: a 400 Gb/s NDR port)

The record has the reference's keys.  ``xla_cost_analysis`` holds the
trace's own totals (an eager trace has no loop body counted once), and
``memory_analysis`` the per-device bytes of the step's arguments and
results, the results that reuse an argument's storage (``alias_bytes``:
a decode cache written in place) and the live-bytes peak of the step's
intermediates (``temp_bytes``).

The reference's ``--fused`` flag (a cost model in which the attention
and scan tiles stay on chip) has no counterpart: the port's kernels are
fused already, and each records its own bytes.

The process group is set up by :func:`run_cell` (and so by :func:`main`)
only, never at import, as the reference sets its forced device count at
the top of its entry module only.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--out-dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "active_param_count",
           "model_flops", "fake_process_group", "run_cell", "main"]

PEAK_FLOPS = 989e12      # dense bf16 tensor cores, H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12         # bytes/s HBM3, H100 SXM (NVIDIA data sheet)
# bytes/s a card over the pod axis: one ConnectX-7 NDR InfiniBand port,
# 400 Gb/s (NVIDIA ConnectX-7 data sheet), where that axis leaves the node
LINK_BW = 50e9


def active_param_count(cfg) -> int:
    """6 N D counts only the routed experts a token reaches: an MoE
    leaf under ``moe/w`` counts ``top_k / n_experts`` of its size."""
    import math
    from ..models.common import flatten_specs
    from ..models.model import build_specs
    total = 0
    for path, spec in flatten_specs(build_specs(cfg)):
        n = math.prod(spec.shape)
        if cfg.moe is not None and "/moe/w" in "/" + path:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


def model_flops(cfg, cell) -> int:
    """The model FLOPs of one step of ``cell``: 6 N D for training, 2 N D
    for a prefill or a decode step (N the active parameters, D the
    step's tokens)."""
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    return (6 if cell.kind == "train" else 2) * active_param_count(cfg) * \
        tokens


def fake_process_group(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks in this process,
    as rank 0: the one already set up when its size matches, else a new
    one (a fake group of another size is replaced; any other group
    raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is set up: the dry "
                "run lays its meshes over a fake group of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _layout(multi_pod: bool, mesh):
    """(Mesh, DeviceMesh) of the cell: the production mesh, or ``mesh``,
    a shape over the production axes of its length (``(2, 2, 2)``: pod,
    data, model).  A mesh of one rank holds every tensor whole: it has
    no ``DeviceMesh`` (None), and the step runs on plain meta tensors,
    with no process group."""
    import math
    import torch
    from ..parallel.sharding import Mesh
    from .mesh import make_production_mesh, mesh_over_group, production_axes
    shape, axes = production_axes(multi_pod)
    if mesh is not None:
        shape = tuple(mesh)
        axes = ("pod", "data", "model")[-len(shape):]
    n = math.prod(shape)
    if n == 1:
        return Mesh((torch.device("meta"),), axes, shape), None
    fake_process_group(n)
    if mesh is None:
        return make_production_mesh(multi_pod=multi_pod)
    return mesh_over_group(shape, axes)


def _argument_bytes(tree, read: set) -> int:
    """Bytes of this rank's part of every tensor of ``tree`` that the
    step read (XLA keeps only the arguments a jitted step uses)."""
    from ..parallel.sharding import is_dtensor
    from .op_stats import _tensors
    total = 0
    for t in _tensors(tree):
        local = t._local_tensor if is_dtensor(t) else t
        if local.untyped_storage()._cdata in read:
            total += local.numel() * local.element_size()
    return total


def _storages(tree) -> dict:
    from ..parallel.sharding import is_dtensor
    from .op_stats import _tensors
    out = {}
    for t in _tensors(tree):
        local = t._local_tensor if is_dtensor(t) else t
        st = local.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _replicating(device_mesh):
    """DTensor's ``implicit_replication`` over a mesh of ranks: a tensor
    the step makes itself (positions, masks, a zero state) is the same on
    every rank, so it enters a DTensor operation replicated.  Nothing on
    one rank."""
    if device_mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def run_cell(arch: str, shape: str, multi_pod: bool, mesh=None,
             overrides: dict | None = None, cell=None) -> dict:
    """One cell's record.  ``mesh``: a mesh shape in place of the
    production one (:func:`_layout`); ``overrides``:
    model-config fields replaced; ``cell``: a ``ShapeCell`` in place of
    ``SHAPES[shape]`` (another batch or sequence)."""
    from ..configs import SHAPES, get_config, supports
    from ..models.model import plan
    from ..parallel.sharding import Sharder, ShardingRules
    from . import steps as ST
    from .op_stats import OpStats

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = cell or SHAPES[shape]
    ok, why = supports(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod)}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec

    t0 = time.time()
    mesh, device_mesh = _layout(multi_pod, mesh)
    sh = Sharder(mesh, ShardingRules.for_mesh(mesh), device_mesh=device_mesh)
    n_chips = len(mesh.devices)
    if cell.kind == "train":
        opt = ST.default_opt(cfg)
        structs = ST.input_structs(cfg, cell, opt, sh)
        step = ST.make_train_step(cfg, opt, sh)
        args = (structs["params"], structs["opt_state"], structs["batch"])
    elif cell.kind == "prefill":
        structs = ST.input_structs(cfg, cell, sh=sh)
        step = ST.make_prefill_step(cfg, sh)
        args = (structs["params"], structs["batch"])
    else:
        structs = ST.input_structs(cfg, cell, sh=sh)
        step = ST.make_decode_step(cfg, sh)
        # the port's decode step takes its position as a host integer:
        # the last of the cell's context (its work does not depend on it)
        args = (structs["params"], structs["cache"], structs["tokens"],
                cell.seq - 1)
    t_lower = time.time() - t0
    with _replicating(device_mesh), OpStats() as stats:
        out = step(*args)
    t_trace = time.time() - t0 - t_lower
    st = stats.result()

    arg_bytes = _argument_bytes(args, stats.read)
    if cell.kind == "decode" and any(g.kind != "mamba" for g in plan(cfg)):
        # the reference's int32 position argument, which every layer that
        # keeps keys reads (its rotation, its cache slot, its mask)
        arg_bytes += structs["pos"].element_size()
    arg_st = _storages(structs)
    out_st = _storages(out)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    flops, byts, coll = st["flops"], st["bytes"], st["collective_total"]
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": byts / HBM_BW,
             "collective_s": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    n_active = active_param_count(cfg)
    useful = model_flops(cfg, cell)
    hlo_global = flops * n_chips
    rec.update(
        status="ok",
        kind=cell.kind,
        n_chips=n_chips,
        lower_s=round(t_lower, 1),
        compile_s=round(t_trace, 1),
        per_device={
            "flops": flops,
            "bytes": byts,
            "collective_bytes": st["collective_bytes"],
            "collective_count": st["collective_count"],
            "gemm_flops": st["gemm_flops"],
            "flops_by_op": st["flops_by_op"],
            "kernel_launches": st["kernel_launches"],
        },
        xla_cost_analysis={"flops_1iter": flops, "bytes_1iter": byts},
        memory_analysis={
            "argument_bytes": arg_bytes,
            "output_bytes": sum(out_st.values()),
            "temp_bytes": st["peak_live_bytes"],
            "alias_bytes": alias,
        },
        roofline={**{k: round(v, 6) for k, v in terms.items()},
                  "dominant": dominant,
                  "bound_s": round(max(terms.values()), 6)},
        model_flops=useful,
        n_active_params=n_active,
        hlo_flops_global=hlo_global,
        useful_flops_ratio=round(useful / max(hlo_global, 1), 4),
        roofline_fraction=round(
            (useful / PEAK_FLOPS / n_chips)
            / max(max(terms.values()), 1e-12), 4),
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--override", default="",
                    help="comma k=v model-config overrides (perf experiments)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            overrides[k] = v

    os.makedirs(args.out_dir, exist_ok=True)

    def one(arch, shape, multipod):
        tag = f"{arch}_{shape}_{_mesh_name(multipod)}"
        if overrides:
            tag += "_" + "-".join(f"{k}={v}" for k, v in overrides.items())
        path = os.path.join(args.out_dir, tag + ".json")
        try:
            rec = run_cell(arch, shape, multipod, overrides=overrides or None)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "mesh": _mesh_name(multipod),
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-4000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "status", "compile_s",
                           "roofline", "useful_flops_ratio",
                           "roofline_fraction", "error")}, default=float),
              flush=True)
        return rec["status"]

    if args.all:
        from ..configs import ARCHS, SHAPES
        status = [one(arch, shape, mp) for arch in ARCHS for shape in SHAPES
                  for mp in (False, True)]
    else:
        status = [one(args.arch, args.shape, args.multipod)]
    return 1 if "error" in status else 0


if __name__ == "__main__":
    raise SystemExit(main())
