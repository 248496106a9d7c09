"""The port's MoE block against the reference's, on the CPU.

``reduced(qwen3-moe-235b-a22b)`` (8 experts, top 2, width 64 over d 128)
and variants with the reference's optional parts (``router_scale_bias``
with a drawn bias; one shared expert; top 8 of 16), with parameters from
the reference's ``init_params``.  The reference's ``moe_apply`` runs
under ``make_test_mesh()`` and its ``Sharder``: one device, so it routes
every token among all experts, as the port does.

Checked, each exactly unless a tolerance is stated:

* the routing: on the same float32 router logits, the chosen experts
  equal ``jax.lax.top_k``'s, ties to the lower expert (logits with many
  ties), the gates equal the reference's softmax to 1e-6 relative (two
  float32 softmaxes), and each expert's slots — tokens, gates, the
  capacity and the dropped assignments — equal the reference's
  ``top_k`` over ``-arange`` priorities, also where an expert overflows
  its capacity;
* the router logits: the float32 product, to 1e-5 relative (a sum of
  128 products in another order), and a refusal of reduced-precision
  float32 products;
* the combine: bitwise the reference's bf16 ``.at[].add`` on the same
  rows (XLA rounds to bf16 after every add, in the update order: expert
  by expert), at top 8 with drops, and not the float32 sum rounded once;
* ``moe_apply``: the output within 2^-7 of its largest value (the
  expert products are bf16 products rounded once on both sides, summed
  in other orders, so single values flip by one ulp), and two runs give
  the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import make_test_mesh
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec
from repro.models.moe import MoECfg as JaxMoECfg
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_specs as jax_moe_specs
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.common import flatten_specs
from repro_torch.models.moe import MoECfg

ARCH = "qwen3-moe-235b-a22b"
REL_TOL = 2 ** -7
VARIANTS = {
    "qwen3": {},
    "bias": {"router_scale_bias": True},
    "shared": {"n_shared": 1},
    "top8": {"n_experts": 16, "top_k": 8},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread is faster and leaves the
    other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    m = make_test_mesh()
    return m, Sharder(m)


def _cfgs(variant: str):
    """(jax cfg, port cfg) of the reduced arch with ``variant``'s MoE."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    kw = {**dataclasses.asdict(cfg.moe), **VARIANTS[variant]}
    return (dataclasses.replace(jcfg, moe=JaxMoECfg(**kw)),
            dataclasses.replace(cfg, moe=MoECfg(**kw)))


def _params(variant: str, seed: int = 1):
    """The MoE block's parameters: (jax tree, port tree holding the same
    values).  A drawn router bias, so that it moves the choice."""
    jcfg, cfg = _cfgs(variant)
    jp = jax_init_params(jax_moe_specs(jcfg), jax.random.PRNGKey(seed))
    if "router_bias" in jp:
        jp["router_bias"] = jnp.asarray(np.random.default_rng(seed).normal(
            0, 0.3, jp["router_bias"].shape).astype(np.float32))
    specs = moe.moe_specs(cfg)
    host = jax.device_get(jp)
    assert sorted(host) == sorted(specs)
    p = {}
    for name, spec in specs.items():
        a = np.asarray(host[name])
        assert (tuple(a.shape), a.dtype.name) == (spec.shape, spec.dtype)
        p[name] = torch.from_numpy(np.array(a, np.float32)).to(
            torch.float32 if spec.dtype == "float32" else torch.bfloat16)
    return jp, p


def _x(rng, T, d=128):
    a = jnp.asarray(rng.standard_normal((1, T, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jax_routing(logits: np.ndarray, m, bias=None) -> dict:
    """The reference's routing lines (``repro.models.moe.moe_apply``'s
    ``local``, one device) on float32 logits [T, E]."""
    T, E = logits.shape
    k = m.top_k
    cap = max(4, int(T * k * m.capacity_factor / E))
    lg = jnp.asarray(logits)
    sel = jax.nn.sigmoid(lg) + bias if bias is not None else lg
    _, top_idx = jax.lax.top_k(sel, k)
    gates = jax.nn.softmax(jnp.take_along_axis(lg, top_idx, 1), axis=-1)
    flat_e, flat_g = top_idx.reshape(-1), gates.reshape(-1)
    match = flat_e[None, :] == jnp.arange(E, dtype=jnp.int32)[:, None]
    prio = jnp.where(match, -jnp.arange(T * k, dtype=jnp.int32),
                     jnp.int32(-(1 << 30)))
    sel_p, sel_i = jax.lax.top_k(prio, cap)
    ok = sel_p > -(1 << 30)
    return {"experts": np.asarray(top_idx), "gates": np.asarray(gates),
            "cap": cap, "ok": np.asarray(ok),
            "tok": np.asarray(jnp.where(ok, sel_i // k, 0)),
            "gate": np.asarray(jnp.where(ok, flat_g[sel_i], 0.0))}


def _check_routing(r: dict, want: dict) -> None:
    assert r["cap"] == want["cap"]
    np.testing.assert_array_equal(r["experts"].numpy(), want["experts"])
    np.testing.assert_allclose(r["gates"].numpy(), want["gates"], rtol=1e-6,
                               atol=0)
    # a slot is filled exactly where the reference's is, with its token
    filled = np.zeros_like(want["ok"])
    E, cap = want["tok"].shape
    rank, kept, ex = r["rank"].numpy(), r["kept"].numpy(), \
        r["experts"].numpy()
    filled[ex[kept], rank[kept]] = True
    np.testing.assert_array_equal(filled, want["ok"])
    np.testing.assert_array_equal(r["tok"].numpy(), want["tok"])
    np.testing.assert_allclose(r["gate"].numpy(), want["gate"], rtol=1e-6,
                               atol=0)
    # every assignment is kept or dropped: kept ones fill the slots
    assert int(kept.sum()) == int(want["ok"].sum())


# ---------------------------------------------------------------------- #
# specs and capacity
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_specs_equal_the_reference(variant):
    jcfg, cfg = _cfgs(variant)
    ref = jax.tree.flatten_with_path(jax_moe_specs(jcfg), is_leaf=is_spec)[0]
    port = flatten_specs(moe.moe_specs(cfg))
    assert ["/".join(k.key for k in kp) for kp, _ in ref] == \
        [p for p, _ in port]
    for (_, r), (_, s) in zip(ref, port):
        assert (tuple(r.shape), r.dtype, r.init, r.scale, tuple(r.axes)) == \
            (tuple(s.shape), s.dtype, s.init, s.scale, tuple(s.axes))


def test_capacity_is_the_reference_rule():
    """``max(4, int(T k capacity_factor / E))`` at one device: 640 for
    the card's 2 x 4,096 prefill of the full config, 80 for its 1,024
    tokens, 4 in a decode step; the reduced config's 10 at 32 tokens."""
    m = get_config(ARCH).moe
    assert [moe.capacity(m, t) for t in (8192, 1024, 2, 4)] == [640, 80, 4, 4]
    assert moe.capacity(reduced(get_config(ARCH)).moe, 32) == 10


# ---------------------------------------------------------------------- #
# routing
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["random", "overflow", "ties", "bias"])
def test_routing_matches_the_reference(case):
    """On the same float32 logits: random ones; expert 0 raised for
    every token, so it overflows its capacity and the later tokens are
    dropped; integer logits with many ties; and the biased sigmoid
    choice."""
    _, cfg = _cfgs("bias" if case == "bias" else "top8")
    m = cfg.moe
    rng = np.random.default_rng(7)
    T = 96
    logits = rng.standard_normal((T, m.n_experts)).astype(np.float32)
    bias = None
    if case == "overflow":
        logits[:, 0] += 3.0
    elif case == "ties":
        logits = rng.integers(0, 3, logits.shape).astype(np.float32)
    elif case == "bias":
        bias = rng.normal(0, 0.3, m.n_experts).astype(np.float32)
    p = {} if bias is None else {"router_bias": torch.from_numpy(bias)}
    r = moe.route(p, torch.from_numpy(logits), m)
    want = _jax_routing(logits, m, None if bias is None else
                        jnp.asarray(bias))
    _check_routing(r, want)
    dropped = int((~r["kept"]).sum())
    if case == "overflow":
        assert dropped == T - r["cap"] > 0
        # the tokens dropped from expert 0 are the last ones
        at0 = (r["experts"] == 0) & ~r["kept"]
        assert at0.any(dim=1).nonzero().min() == r["cap"]
    if case == "ties":
        # every row is tied somewhere inside or across its top-k boundary
        s = np.sort(logits, axis=1)[:, ::-1]
        assert (s[:, m.top_k - 1] == s[:, m.top_k]).mean() > 0.5


def test_router_logits_match_and_refuse_reduced_precision():
    jcfg, cfg = _cfgs("qwen3")
    jp, p = _params("qwen3")
    jx, x = _x(np.random.default_rng(8), 40)
    want = np.asarray(jx[0].astype(jnp.float32) @ jp["router"])
    got = moe.router_logits(p, x[0])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="float32"):
            moe.router_logits(p, x[0])
    finally:
        torch.set_float32_matmul_precision(prec)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            moe.router_logits(p, x[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ---------------------------------------------------------------------- #
# combine and the whole block
# ---------------------------------------------------------------------- #
def test_combine_is_the_reference_scatter_add():
    """The same gated expert rows, combined by the port and by the
    reference's ``jnp.zeros(...).at[tok].add(ys, mode="drop")``: the
    same bits at top 8 with drops, and not those of a float32 sum
    rounded once."""
    _, cfg = _cfgs("top8")
    m = cfg.moe
    rng = np.random.default_rng(9)
    T, d = 200, 128
    logits = rng.standard_normal((T, m.n_experts)).astype(np.float32)
    logits[:, 3] += 1.0                     # expert 3 overflows
    r = moe.route({}, torch.from_numpy(logits), m)
    assert (~r["kept"]).any()
    E, cap = r["tok"].shape
    ys = torch.from_numpy(rng.standard_normal((E, cap, d)).astype(
        np.float32) * 30).to(torch.bfloat16)
    ys = ys * (r["gate"] > 0)[..., None].to(ys.dtype)   # empty slots 0
    got = moe.combine(ys, r)
    jys = jnp.asarray(ys.float().numpy()).astype(jnp.bfloat16)
    want = jax.jit(lambda y, t: jnp.zeros((T, d), jnp.bfloat16).at[
        t.reshape(-1)].add(y.reshape(-1, d), mode="drop"))(
            jys, jnp.asarray(r["tok"].numpy()))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    rows = torch.cat([ys.reshape(E * cap, d), ys.new_zeros(1, d)]).float()
    idx = torch.where(r["kept"], r["experts"] * cap + r["rank"], E * cap)
    once = rows[idx].sum(1).to(torch.bfloat16)
    assert not torch.equal(once, got)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_apply_matches_the_reference(variant, mesh):
    """The block's output on 2 x 48 tokens (capacity 30 at top 2 of 8,
    60 at top 8 of 16), its routing against the reference's lines, and a
    second run's bits."""
    m_, sh = mesh
    jcfg, cfg = _cfgs(variant)
    jp, p = _params(variant)
    rng = np.random.default_rng(10)
    jx = jnp.asarray(rng.standard_normal((2, 48, 128)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    x = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    with jax.set_mesh(m_):
        want = jax.jit(lambda p, x: jax_moe_apply(p, x, jcfg, sh))(jp, jx)
    got = moe.moe_apply(p, x, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    assert torch.equal(moe.moe_apply(p, x, cfg), got)
    # the routing of these tokens against the reference's lines
    xt = x.reshape(-1, 128)
    lg = moe.router_logits(p, xt)
    r = moe.route(p, lg, cfg.moe)
    _check_routing(r, _jax_routing(
        lg.numpy(), cfg.moe,
        jnp.asarray(jp["router_bias"]) if "router_bias" in jp else None))


def test_params_from_jax_carries_the_moe_leaves():
    """``convert.params_from_jax`` on a whole reduced MoE model: the
    float32 router and the bf16 experts keep every bit."""
    jcfg, cfg = _cfgs("bias")
    from repro.models.model import build_specs as jax_build_specs
    jparams = jax_init_params(jax_build_specs(jcfg), jax.random.PRNGKey(3))
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    e = params["groups"]["e"]["moe"]
    assert e["router"].dtype == e["router_bias"].dtype == torch.float32
    assert e["wi"].dtype == torch.bfloat16
    want = jax.tree.leaves(jax.device_get(jparams))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
