"""Shared model machinery: parameter specs, numpy init, norms, RoPE, MLP.

A model's parameters are described by a tree of :class:`ParamSpec` (nested
dicts).  :func:`init_params_np` turns a spec tree into float32 numpy arrays
from a seed, with no framework involved, so the same weights can be fed to
this package and to any other implementation of the same model;
:func:`params_to_torch` rounds them to each spec's dtype on a device, and
:func:`init_params` does both a block at a time (:func:`leaf_blocks_np`),
so that a model larger than the host's memory in float32 is drawn a
part of a layer at a time.  Each spec names the logical
sharding axis of every dim (``axes``); :func:`param_shardings` resolves
them against a ``parallel.sharding.Sharder``.

The numerics keep the reference model's cast points: the norm and RoPE
compute in float32 and cast back to the input's dtype, projections give
bf16 (``proj``), and :func:`fdot` accumulates in float32.  On DTensors
(a model laid out over ranks, ``launch.dryrun``) both products run on
each rank's shards through :func:`split_einsum`.
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import as_dtensor, is_dtensor, reduce_partial

__all__ = ["ParamSpec", "flatten_specs", "spec_leaf_np", "leaf_blocks_np",
           "init_params_np", "params_to_torch", "count_params",
           "param_shardings", "fdot", "proj", "split_einsum", "rmsnorm",
           "rope_freqs", "apply_rope", "activation", "GATED_ACTS", "mlp_specs",
           "mlp_apply", "pad_vocab", "group_rows", "init_params",
           "init_scale_out", "abstract_params", "meta_tensor", "device_of",
           "trainable"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}
# float32 elements in one block that leaf_blocks_np draws (256 MiB)
_BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: str = "bfloat16"
    init: str = "normal"        # normal | zeros | ones | mamba_a | dt_bias
    scale: float = 0.02
    axes: Optional[tuple] = None    # logical sharding name of each dim


def flatten_specs(tree, prefix: str = "") -> list:
    """``[(path, spec)]`` of a nested dict of specs, keys sorted at every
    level (the leaf order of a JAX pytree of dicts).  Any non-dict is a
    leaf, so a tree of objects with ``shape``/``init``/``scale`` fields
    flattens the same way."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten_specs(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _draw(spec, rng, shape: tuple) -> np.ndarray:
    """The next ``shape`` float32 values of ``spec``'s init from ``rng``."""
    if spec.init == "zeros":
        return np.zeros(shape, np.float32)
    if spec.init == "ones":
        return np.ones(shape, np.float32)
    if spec.init == "mamba_a":
        a = np.log(np.arange(1, spec.shape[-1] + 1, dtype=np.float32))
        return np.ascontiguousarray(np.broadcast_to(a, shape))
    if spec.init == "dt_bias":
        u = rng.random(shape, dtype=np.float32) * np.float32(0.099) \
            + np.float32(1e-3)
        return np.log(np.expm1(u))
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= np.float32(spec.scale)
    return x


def spec_leaf_np(spec, seed: int, index: int,
                 rows: Optional[int] = None) -> np.ndarray:
    """The float32 array of leaf ``index`` of a spec tree, from ``seed``.

    Each leaf draws from its own ``np.random.default_rng([seed, index])``:
    ``normal`` is a float32 standard normal times ``scale``; ``dt_bias``
    is the inverse softplus of a uniform draw in [1e-3, 1e-1); ``mamba_a``
    is ``log(1..N)`` over the last axis; ``zeros``/``ones`` draw nothing.
    ``rows`` keeps the first ``rows`` rows of the first axis: numpy fills
    an array in C order from one stream, so they equal the whole leaf's
    (the first layers of a stacked leaf, at the whole model's scale).
    """
    shape = tuple(spec.shape)
    if rows is not None:
        shape = (min(rows, shape[0]),) + shape[1:]
    return _draw(spec, np.random.default_rng([seed, index]), shape)


def leaf_blocks_np(spec, seed: int, index: int, rows: Optional[int] = None):
    """:func:`spec_leaf_np` in blocks of at most ``_BLOCK_ELEMS`` elements
    cut in C order: yields ``(start, stop, block)`` with ``block`` the
    float32 elements ``start:stop`` of the flattened leaf.

    A block may be part of a row, so the host holds at most
    ``_BLOCK_ELEMS`` float32 values whatever the leaf's shape (one layer
    of a stacked MoE ``wi`` is 1.6 B values); the blocks come in order
    from the leaf's one generator, which fills C order from one stream,
    so together they are the whole leaf bit for bit.  ``rows`` stops
    after the first ``rows`` rows of the first axis (the first layers of
    a stacked leaf, at the whole model's scale).  A leaf needs at least
    one axis."""
    shape = tuple(spec.shape)
    if not shape:
        raise ValueError("a 0-d leaf has no rows to draw in blocks")
    n = shape[0] if rows is None else min(rows, shape[0])
    total = n * math.prod(shape[1:])
    rng = np.random.default_rng([seed, index])
    for start in range(0, total, _BLOCK_ELEMS):
        stop = min(start + _BLOCK_ELEMS, total)
        if spec.init == "mamba_a":          # log(1..N) along the last axis
            a = _draw(spec, rng, (spec.shape[-1],))
            yield start, stop, a[np.arange(start, stop) % len(a)]
        else:
            yield start, stop, _draw(spec, rng, (stop - start,))


def _nest(paths: list, values: list) -> dict:
    """The nested dict of ``flatten_specs``' paths holding ``values``."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def init_params_np(specs, seed: int = 0) -> dict:
    """Float32 numpy arrays for every leaf of ``specs``, in the same nested
    dict layout (see :func:`spec_leaf_np`)."""
    leaves = flatten_specs(specs)
    return _nest([p for p, _ in leaves],
                 [spec_leaf_np(spec, seed, i)
                  for i, (_, spec) in enumerate(leaves)])


def params_to_torch(specs, arrays, device) -> dict:
    """Each float32 array of ``arrays`` as a tensor of its spec's dtype on
    ``device`` (float32 to bf16 rounds to nearest even)."""
    if isinstance(specs, dict):
        return {k: params_to_torch(specs[k], arrays[k], device)
                for k in specs}
    # ascontiguousarray makes a 0-d array 1-d: keep the leaf's shape
    t = torch.from_numpy(np.ascontiguousarray(arrays, np.float32)
                         .reshape(np.shape(arrays)))
    return t.to(device=device).to(_DTYPES[specs.dtype])


def group_rows(specs, layers: Optional[int]) -> dict:
    """``{group name: layers kept}`` when a model is cut to its first
    ``layers`` layers: the groups of ``specs["groups"]`` in the model's
    order (``build_specs`` adds them in the block program's order), each
    stacked over its layers, keep their layers in turn until ``layers``
    are kept (DeepSeek-V3's 4: 3 of ``d``, 1 of ``e``).  None keeps
    every layer."""
    out, left = {}, layers
    for name, tree in specs.get("groups", {}).items():
        n = flatten_specs(tree)[0][1].shape[0]
        out[name] = n if left is None else min(n, left)
        if left is not None:
            left -= out[name]
    return out


def init_params(specs, seed: int, device, threads: int = 1,
                layers: Optional[int] = None) -> dict:
    """:func:`init_params_np` then :func:`params_to_torch`, one block at a
    time (:func:`leaf_blocks_np`), each written into its leaf's tensor of
    the spec's dtype on ``device``: the host holds one float32 block a
    thread, never a whole float32 leaf.  ``threads`` > 1 draws that many
    leaves at once, the largest first (numpy's fills release the GIL);
    each leaf's stream stays in one thread, so the weights are the same
    whatever ``threads``.

    ``layers`` keeps the first ``layers`` layers of the whole model, a
    group's first layers of each of its stacked leaves (those under
    ``groups``) as :func:`group_rows` counts them, drawn at the scales of
    ``specs``: for a config cut in depth."""
    leaves = flatten_specs(specs)
    keep = group_rows(specs, layers)

    def one(i: int) -> torch.Tensor:
        path, spec = leaves[i]
        if not spec.shape:
            return params_to_torch(spec, spec_leaf_np(spec, seed, i), device)
        rows = keep[path.split("/")[1]] if path.startswith("groups/") \
            else None
        shape = tuple(spec.shape) if rows is None else \
            (min(rows, spec.shape[0]),) + tuple(spec.shape[1:])
        out = torch.empty(shape, dtype=_DTYPES[spec.dtype], device=device)
        flat = out.view(-1)
        for start, stop, block in leaf_blocks_np(spec, seed, i, rows):
            flat[start:stop] = torch.from_numpy(block).to(device).to(
                out.dtype)
        return out

    order = sorted(range(len(leaves)),
                   key=lambda i: -math.prod(leaves[i][1].shape))
    if threads > 1:
        with ThreadPoolExecutor(threads) as pool:
            made = dict(zip(order, pool.map(one, order)))
    else:
        made = {i: one(i) for i in order}
    return _nest([p for p, _ in leaves], [made[i] for i in range(len(leaves))])


def abstract_params(specs, sh=None) -> dict:
    """The parameter tree of ``specs`` as tensors on the ``meta`` device:
    shapes and dtypes, no storage (the reference's ``ShapeDtypeStruct``
    stand-ins).  With a sharder that has a ``DeviceMesh``, each leaf is a
    meta DTensor placed as :func:`param_shardings` places it: its local
    tensor is this rank's shard."""
    if isinstance(specs, dict):
        return {k: abstract_params(v, sh) for k, v in specs.items()}
    return meta_tensor(specs.shape, _DTYPES[specs.dtype],
                       None if sh is None else
                       sh.sharding(specs.axes, specs.shape), sh)


def meta_tensor(shape, dtype, placement=None, sh=None) -> torch.Tensor:
    """An empty ``meta`` tensor of ``shape``; with a :class:`Placement`
    and a sharder that has a ``DeviceMesh``, a DTensor of that global
    shape whose local tensor is a meta shard (every split divides its
    dim, as ``Sharder.sharding`` with a shape leaves it)."""
    shape = tuple(shape)
    if placement is None or sh is None or sh.device_mesh is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor, Shard
    dims = placement.dtensor_placements()
    local = list(shape)
    for p, n in zip(dims, sh.device_mesh.shape):
        if isinstance(p, Shard):
            local[p.dim] //= n
    t = torch.empty(local, dtype=dtype, device="meta")
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(t, sh.device_mesh, dims, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def device_of(t: torch.Tensor) -> torch.device:
    """The device that holds ``t``'s data: a DTensor's local tensor's
    (a DTensor's own ``device`` is its mesh's device type)."""
    local = getattr(t, "_local_tensor", None)
    return t.device if local is None else local.device


def trainable(tree) -> dict:
    """A parameter tree whose leaves autograd tracks: each leaf detached
    (sharing its storage) with ``requires_grad``."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in flatten_specs(specs))


def param_shardings(specs, sh) -> dict:
    """Each leaf's placement on ``sh``'s mesh (``Sharder.sharding`` of its
    ``axes`` and shape), in the spec tree's layout."""
    if isinstance(specs, dict):
        return {k: param_shardings(v, sh) for k, v in specs.items()}
    return sh.sharding(specs.axes, specs.shape)


# ---------------------------------------------------------------------- #
# numerics
# ---------------------------------------------------------------------- #
def fdot(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum accumulated in float32 (products of bf16 inputs are exact)."""
    if is_dtensor(a) or is_dtensor(b):
        return split_einsum(subscripts, a, b, torch.float32)
    return torch.einsum(subscripts, a.float(), b.float())


def proj(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 projection: bf16 inputs, float32 accumulation inside the
    matrix product, bf16 out."""
    if is_dtensor(a) or is_dtensor(b):
        return split_einsum(subscripts, a, b, torch.bfloat16)
    return torch.einsum(subscripts, a.to(torch.bfloat16),
                        b.to(torch.bfloat16))


def _split_letter(p, subs: str):
    from torch.distributed.tensor import Shard
    return subs[p.dim] if isinstance(p, Shard) else None


def split_einsum(subscripts: str, a, b, dtype) -> torch.Tensor:
    """``einsum(subscripts, a, b)`` in ``dtype`` on DTensors, each rank on
    its own shards (``local_map``), partitioned as GSPMD partitions a dot
    on each mesh dim: a letter split in one operand stays split (in the
    output if it is there, else the output is a partial sum, the other
    operand cut to match); two different letters split on one mesh dim
    gather the smaller operand's.  A partial-sum output is reduced at
    once (a row-parallel projection's all-reduce), so that each partial
    sum is reduced once whatever reads it.  An operand's gradient is
    split as the operand is, or a partial sum where only the other
    operand is split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lhs, out = subscripts.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    dm = (a if is_dtensor(a) else b).device_mesh
    a, b = (as_dtensor(reduce_partial(t), dm) for t in (a, b))
    small_a = a._local_tensor.numel() <= b._local_tensor.numel()
    pa, pb, po, ga, gb = [], [], [], [], []
    for i in range(dm.ndim):
        la = _split_letter(a.placements[i], sa)
        lb = _split_letter(b.placements[i], sb)
        if la and lb and la != lb:
            la, lb = (None, lb) if small_a else (la, None)
        ltr = la or lb
        if ltr is None:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
            ga.append(Replicate())
            gb.append(Replicate())
            continue
        pa.append(Shard(sa.index(ltr)) if ltr in sa else Replicate())
        pb.append(Shard(sb.index(ltr)) if ltr in sb else Replicate())
        po.append(Shard(out.index(ltr)) if ltr in out else Partial())
        ga.append(pa[-1] if ltr in sa else Partial())
        gb.append(pb[-1] if ltr in sb else Partial())
    y = local_map(
        lambda u, w: torch.einsum(subscripts, u.to(dtype), w.to(dtype)),
        out_placements=po, in_placements=(pa, pb),
        in_grad_placements=(ga, gb), device_mesh=dm,
        redistribute_inputs=True)(a, b)
    return reduce_partial(y)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: [...]; returns float32 cos, sin of shape [..., hd/2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [..., hd], split halves (not interleaved); cos/sin broadcast to
    [..., hd/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; torch's is the erf
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    """The elementwise function of a non-gated MLP (the reference's)."""
    if name in GATED_ACTS:
        raise ValueError("gated activations are handled in the MLP itself")
    return {
        "gelu": _gelu,
        "relu": F.relu,
        "silu": F.silu,
        "sq_relu": lambda x: torch.square(F.relu(x)),
    }[name]


GATED_ACTS = {"swiglu": F.silu, "geglu": _gelu}


def mlp_specs(d_model: int, d_ff: int, act: str, scale_out: float) -> dict:
    if act in GATED_ACTS:
        return {
            "wi": ParamSpec((d_model, 2, d_ff), axes=("fsdp", None, "tp")),
            "wo": ParamSpec((d_ff, d_model), scale=scale_out,
                            axes=("tp", "fsdp")),
        }
    return {
        "wi": ParamSpec((d_model, d_ff), axes=("fsdp", "tp")),
        "wo": ParamSpec((d_ff, d_model), scale=scale_out,
                        axes=("tp", "fsdp")),
    }


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """A gated MLP (``act(x W_gate) * (x W_up)``: SwiGLU, GeGLU) or a
    plain one (``act(x W_in)``), then the down projection; the
    activation runs in float32 and is cast back to x's dtype."""
    if act in GATED_ACTS:
        gu = proj("bsd,dgf->bsgf", x, p["wi"])
        h = GATED_ACTS[act](gu[:, :, 0].float()).to(x.dtype) * gu[:, :, 1]
    else:
        h = proj("bsd,df->bsf", x, p["wi"])
        h = activation(act)(h.float()).to(x.dtype)
    return proj("bsf,fd->bsd", h, p["wo"])


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def init_scale_out(n_layers: int) -> float:
    """Init scale of the output projections."""
    return 0.02 / math.sqrt(2 * n_layers)
