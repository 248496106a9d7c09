"""Shared model machinery: parameter specs, numpy init, norms, RoPE, MLP.

A model's parameters are described by a tree of :class:`ParamSpec` (nested
dicts).  :func:`init_params_np` turns a spec tree into float32 numpy arrays
from a seed, with no framework involved, so the same weights can be fed to
this package and to any other implementation of the same model;
:func:`params_to_torch` rounds them to each spec's dtype on a device.

The numerics keep the reference model's cast points: the norm and RoPE
compute in float32 and cast back to the input's dtype, projections give
bf16 (``proj``), and :func:`fdot` accumulates in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamSpec", "flatten_specs", "spec_leaf_np", "init_params_np",
           "params_to_torch", "count_params", "fdot", "proj", "rmsnorm",
           "rope_freqs", "apply_rope", "mlp_specs", "mlp_apply", "pad_vocab",
           "init_params", "init_scale_out"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: str = "bfloat16"
    init: str = "normal"        # normal | zeros | ones | mamba_a | dt_bias
    scale: float = 0.02


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


def spec_leaf_np(spec, seed: int, index: int) -> np.ndarray:
    """The float32 array of leaf ``index`` of a spec tree, from ``seed``.

    Each leaf draws from its own ``np.random.default_rng([seed, index])``:
    ``normal`` is a float32 standard normal times ``scale``; ``dt_bias``
    is the inverse softplus of a uniform draw in [1e-3, 1e-1); ``mamba_a``
    is ``log(1..N)`` over the last axis; ``zeros``/``ones`` draw nothing.
    """
    shape = tuple(spec.shape)
    if spec.init == "zeros":
        return np.zeros(shape, np.float32)
    if spec.init == "ones":
        return np.ones(shape, np.float32)
    if spec.init == "mamba_a":
        a = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
        return np.ascontiguousarray(np.broadcast_to(a, shape))
    rng = np.random.default_rng([seed, index])
    if spec.init == "dt_bias":
        u = rng.random(shape, dtype=np.float32) * np.float32(0.099) \
            + np.float32(1e-3)
        return np.log(np.expm1(u))
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= np.float32(spec.scale)
    return x


def init_params_np(specs, seed: int = 0) -> dict:
    """Float32 numpy arrays for every leaf of ``specs``, in the same nested
    dict layout (see :func:`spec_leaf_np`)."""
    out: dict = {}
    for i, (path, spec) in enumerate(flatten_specs(specs)):
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = spec_leaf_np(spec, seed, i)
    return out


def params_to_torch(specs, arrays, device) -> dict:
    """Each float32 array of ``arrays`` as a tensor of its spec's dtype on
    ``device`` (float32 to bf16 rounds to nearest even)."""
    if isinstance(specs, dict):
        return {k: params_to_torch(specs[k], arrays[k], device)
                for k in specs}
    t = torch.from_numpy(np.ascontiguousarray(arrays, np.float32))
    return t.to(device=device).to(_DTYPES[specs.dtype])


def init_params(specs, seed: int, device) -> dict:
    """:func:`init_params_np` then :func:`params_to_torch`, one leaf at a
    time, so that the host never holds more than one float32 leaf."""
    leaves = flatten_specs(specs)
    index = {path: i for i, (path, _) in enumerate(leaves)}

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}/{k}" if prefix else k)
                    for k in tree}
        return params_to_torch(tree, spec_leaf_np(tree, seed, index[prefix]),
                               device)
    return build(specs, "")


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in flatten_specs(specs))


# ---------------------------------------------------------------------- #
# numerics
# ---------------------------------------------------------------------- #
def fdot(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum accumulated in float32 (products of bf16 inputs are exact)."""
    return torch.einsum(subscripts, a.float(), b.float())


def proj(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 projection: bf16 inputs, float32 accumulation inside the
    matrix product, bf16 out."""
    return torch.einsum(subscripts, a.to(torch.bfloat16),
                        b.to(torch.bfloat16))


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


def mlp_specs(d_model: int, d_ff: int, act: str, scale_out: float) -> dict:
    if act != "swiglu":
        raise NotImplementedError(
            f"activation {act!r}: the port runs the SwiGLU MLP only "
            "(ROADMAP queue 1 item 13)")
    return {
        "wi": ParamSpec((d_model, 2, d_ff)),
        "wo": ParamSpec((d_ff, d_model), scale=scale_out),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x W_gate) * (x W_up)``, then the down projection."""
    gu = proj("bsd,dgf->bsgf", x, p["wi"])
    h = F.silu(gu[:, :, 0].float()).to(x.dtype) * gu[:, :, 1]
    return proj("bsf,fd->bsd", h, p["wo"])


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def init_scale_out(n_layers: int) -> float:
    """Init scale of the output projections."""
    return 0.02 / math.sqrt(2 * n_layers)
