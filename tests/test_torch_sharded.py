"""The port's models laid out over real ranks (DTensor on ``gloo``)
against the same models on one device, on real values.

The dry run (``launch.dryrun``) traces the sharded step on ``meta``
tensors, which checks shapes and counts bytes but not the arithmetic
of the layout: a wrong offset into a split keeps every shape.  Here
four ``gloo`` ranks on the CPU, each a child process, run the sharded
path on the same weights and tokens as a one-device run, and rank 0
writes the differences.  Checked, with the tolerance of each:

* the training loss (relative 1e-4) and the gradient of every leaf
  (all leaves together: relative norm of the difference <= 2 %; each
  element within 2^-5 of the largest gradient), through
  ``grads_and_loss(..., sh)``: the vocabulary split of the loss
  (``_logsumexp``, ``_gold_logit``), the split einsums, the attention
  op's local shards and their gradients' placements;
* ``prefill`` (last-token logits within 2^-6 of the largest, every
  cache leaf within 2^-6 of its largest value) and one ``decode_step``
  from the one-device prefill's cache laid out as the dry run lays it
  (``steps._cache_struct``: positions split over ``model``, so one rank
  writes the new slot, ``attention.write_at``);
* for dense, MoE, MLA (with MoE) and hybrid reduced configs on a
  (data 2, model 2) mesh, and the dense one on (data 1, model 4), where
  4 query heads on 2 key heads split so that each rank reads part of a
  key head (``flash_attention.ops._split``'s key-head slice);
* the MoE block alone on identical inputs (``moe_apply`` with a DTensor
  x, tokens over ``data`` and experts over ``model``) against the
  one-device block run on each ``data`` shard's tokens apart, at the
  config's capacity factor: the expert offset ``e0`` and the per-rank
  capacity (from the rank's own token count), within 2^-7 of the
  largest value of the output and of each gradient.

In the whole models an MoE layer's capacity is raised (capacity factor
16: no token dropped on either side), since a rank's capacity comes
from its own tokens; and a rounding difference upstream can move a
token whose two best experts nearly tie to another expert, which moves
its whole contribution: such moves are counted and held to 2 % of the
routes, and the gradient check above is what they are allowed.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ("qwen3-1.7b", "qwen3-moe-235b-a22b", "deepseek-v3-671b",
         "hymba-1.5b")
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")

_CHILD = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import init_params, param_shardings
from repro_torch.parallel.sharding import Mesh, Placement, Sharder, \
    ShardingRules

B, S = 4, 48


def tree_map(f, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k])
    else:
        yield tree


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().float()


def diff(got, want):
    # (max |got - want|, max |want|, sum (got - want)^2, sum want^2)
    g, w = full(got), full(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    d = g - w
    return [float(d.abs().max()), float(w.abs().max()),
            float((d * d).sum()), float((w * w).sum())]


def worst(pairs):
    ds = [diff(a, b) for a, b in pairs]
    return {"max_err": max(d[0] for d in ds),
            "max_ref": max(d[1] for d in ds),
            "leaf_rel": max(d[0] / max(d[1], 1e-30) for d in ds),
            "rel_norm": (sum(d[2] for d in ds) / sum(d[3] for d in ds)) ** .5}


def sharder(shape):
    mesh = Mesh((torch.device("cpu"),) * world, ("data", "model"), shape)
    dm = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return Sharder(mesh, ShardingRules.for_mesh(mesh), device_mesh=dm), dm


def whole_model(arch, sh, dm):
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    specs = M.build_specs(cfg)
    params = init_params(specs, 0, "cpu")
    sharded = tree_map(lambda t, p: distribute_tensor(
        t, dm, p.dtensor_placements(), src_data_rank=None), params,
        param_shardings(specs, sh))
    rng = np.random.default_rng(3)
    toks, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (B, S),
                                                  dtype=np.int32))
                    for _ in range(2))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1),
                                        dtype=np.int32))

    def dp(t):
        return distribute_tensor(t, dm, [Shard(0), Replicate()],
                                 src_data_rank=None)
    r = {}
    routes, route = [], MOE.route
    MOE.route = lambda *a: routes.append(route(*a)) or routes[-1]
    loss0, g0 = ST.grads_and_loss(params, {"tokens": toks,
                                           "labels": labels}, cfg)
    plain_routes = routes[:]
    routes.clear()
    with implicit_replication():
        loss1, g1 = ST.grads_and_loss(
            sharded, {"tokens": dp(toks), "labels": dp(labels)}, cfg, sh)
    MOE.route = route
    r["loss"] = diff(loss1, loss0)
    r["grads"] = worst(zip(leaves(g1), leaves(g0)))
    # routes of this rank's tokens: rows d * B / n_dp onwards
    n_dp = dm.size(0)
    n = B // n_dp * S
    d = dm.get_local_rank("data")
    moved = sum(int((a["experts"][d * n:(d + 1) * n].sort(-1).values
                     != b["experts"].sort(-1).values).any(-1).sum())
                for a, b in zip(plain_routes, routes))
    r["routes"] = [moved, len(routes) * n]
    logits0, cache0 = M.prefill(params, toks, cfg)
    with implicit_replication():
        logits1, cache1 = M.prefill(sharded, dp(toks), cfg, sh=sh)
    r["prefill_logits"] = diff(logits1, logits0)
    r["prefill_cache"] = worst(zip(leaves(cache1), leaves(cache0)))
    laid = tree_map(lambda t, s: distribute_tensor(
        t.clone(), dm, s.placements, src_data_rank=None), cache0,
        ST._cache_struct(cfg, B, S, sh))
    r["cache_positions_split"] = all(
        Shard(1) in t.placements or Shard(2) in t.placements
        for t in leaves(laid))
    logits0, cache0 = M.decode_step(params, cache0, nxt, S, cfg)
    with implicit_replication():
        logits1, cache1 = M.decode_step(sharded, laid, dp(nxt), S, cfg, sh)
    r["decode_logits"] = diff(logits1, logits0)
    r["decode_cache"] = worst(zip(leaves(cache1), leaves(cache0)))
    return r


def moe_block(arch, sh, dm):
    cfg = reduced(get_config(arch))
    specs = M.build_specs(cfg)
    p = {k: v[0] for k, v in
         init_params(specs, 0, "cpu")["groups"]["e"]["moe"].items()}
    place = param_shardings(specs, sh)["groups"]["e"]["moe"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    one = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    split = {k: distribute_tensor(
        v, dm, Placement(place[k].mesh, place[k].spec[1:])
        .dtensor_placements(), src_data_rank=None).requires_grad_(True)
        for k, v in p.items()}
    x0 = x.clone().requires_grad_(True)
    rows = B // dm.size(0)
    routes, route = [], MOE.route
    MOE.route = lambda *a: routes.append(route(*a)) or routes[-1]
    y0 = torch.cat([MOE.moe_apply(one, x0[i:i + rows], cfg)
                    for i in range(0, B, rows)])
    MOE.route = route
    (y0.float() * w).sum().backward()
    x1 = distribute_tensor(x, dm, [Shard(0), Replicate()],
                           src_data_rank=None).requires_grad_(True)
    with implicit_replication():
        y1 = MOE.moe_apply(split, x1, cfg, sh)
        (y1.float() * distribute_tensor(w, dm, [Shard(0), Replicate()],
                                        src_data_rank=None)).sum().backward()
    r = {"y": diff(y1, y0), "x_grad": diff(x1.grad, x0.grad),
         "dropped": sum(int((~rt["kept"]).sum()) for rt in routes)}
    r.update({k + "_grad": diff(split[k].grad, one[k].grad) for k in one
              if one[k].grad is not None})
    return r


res = {}
sh, dm = sharder((2, 2))
for arch in %(archs)r:
    res[f"{arch}@2x2"] = whole_model(arch, sh, dm)
for arch in %(moe)r:
    res[f"{arch}@moe"] = moe_block(arch, sh, dm)
sh, dm = sharder((1, 4))
res["qwen3-1.7b@1x4"] = whole_model("qwen3-1.7b", sh, dm)
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
""" % {"archs": ARCHS, "moe": MOE_ARCHS}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's record of the four ranks' run (one child process each)."""
    d = tmp_path_factory.mktemp("gloo")
    out = d / "out.json"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(WORLD), str(d / "store"),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(e[-3000:] for e in errs)
    return json.loads(out.read_text())


def _within(d, frac):
    """A ``diff`` record [max err, max ref, ...] within ``frac`` of the
    reference's largest value."""
    return d[0] <= frac * d[1]


@pytest.mark.parametrize("cell", [f"{a}@2x2" for a in ARCHS]
                         + ["qwen3-1.7b@1x4"])
def test_sharded_training_step_matches_one_device(sharded, cell):
    r = sharded[cell]
    assert r["loss"][0] <= 1e-4 * r["loss"][1], r["loss"]
    g = r["grads"]
    assert g["rel_norm"] <= 0.02, g
    assert g["max_err"] <= 2 ** -5 * g["max_ref"], g
    moved, total = r["routes"]
    assert moved <= 0.02 * total, r["routes"]
    if not cell.startswith(MOE_ARCHS):
        assert total == 0


@pytest.mark.parametrize("cell", [f"{a}@2x2" for a in ARCHS]
                         + ["qwen3-1.7b@1x4"])
def test_sharded_prefill_and_decode_match_one_device(sharded, cell):
    r = sharded[cell]
    assert r["cache_positions_split"]
    for key in ("prefill_logits", "decode_logits"):
        assert _within(r[key], 2 ** -6), (key, r[key])
    for key in ("prefill_cache", "decode_cache"):
        c = r[key]
        assert c["leaf_rel"] <= 2 ** -6, (key, c)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_block_routes_each_ranks_tokens(sharded, arch):
    r = sharded[f"{arch}@moe"]
    assert r["dropped"] > 0          # the per-rank capacity binds
    grads = [k for k in r if k.endswith("_grad")]
    assert {"x_grad", "router_grad", "wi_grad", "wo_grad"} <= set(grads)
    for key in ["y"] + grads:
        assert _within(r[key], 2 ** -7), (key, r[key])
