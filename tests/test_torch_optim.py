"""The port's AdamW and gradient compression against the reference's, on
the CPU.

``adamw_update`` runs on the same numpy trees in both packages (the
reference eagerly, one XLA operation at a time): float32 and bf16
parameters, float32 and bf16 moments, leaves of 1, 2 and 3 dims (no
weight decay below 2), clipping active and not, without a schedule and
with ``warmup_cosine``, three steps in a row from a state with nonzero
moments.  Every operation of the update is IEEE-exact in both (products,
sums, quotients, ``sqrt``, round-to-nearest-even casts) except two
transcendental functions whose libraries differ: ``b ** step`` (the
bias corrections) and ``cos`` (the schedule).  So the results are held
bitwise, except the schedule's multiplier and what depends on it, held
within ``ULPS`` float32 ulps (measured here: 0 in every update, and 3
for ``warmup_cosine`` alone somewhere over steps 0 to 129);
``global_norm`` sums in another order than XLA's reduction, so
``grad_norm`` is held to ``NORM_RTOL`` (measured: equal) and the clipped
runs, whose scale comes from it, to ``ULPS`` ulps as well (measured:
0).

``compress`` / ``decompress`` / ``compress_tree`` / ``decompress_tree``
are bitwise, half-way cases of the rounding included (``torch.round`` and
``jnp.round`` both round half to even), and ``compressed_psum`` over a
one-device ``pod`` axis equals the reference's ``shard_map``.  The
reference's own cases (``tests/test_substrate.py``) run on the port.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models.common import ParamSpec as JaxParamSpec
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.common import ParamSpec
from repro_torch.optim import adamw, compression
from repro_torch.parallel.sharding import Mesh

ULPS = 4
NORM_RTOL = 1e-6

SHAPES = {"w": ((8, 6), "float32"), "b": ((6,), "float32"),
          "e": ((5, 4), "bfloat16"), "s": ((2, 3, 4), "bfloat16"),
          "n": ((4,), "bfloat16")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(rng, scale: float, dtype=None) -> dict:
    out = {}
    for k, (shape, dt) in SHAPES.items():
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out[k] = a.astype(ml_dtypes.bfloat16 if (dtype or dt) == "bfloat16"
                          else np.float32)
    return out


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in float32 ulps (bit patterns as ordered
    integers) between two arrays."""
    def ordered(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(got) - ordered(want)).max())


def _run_both(cfg_kw: dict, state_dtype: str, grad_scale: float,
              schedule=None, steps: int = 3):
    rng = np.random.default_rng(0)
    params = _np_tree(rng, 0.5)
    m = _np_tree(rng, 0.01, state_dtype)
    v = {k: np.abs(a.astype(np.float32)).astype(a.dtype) * 0.01
         for k, a in _np_tree(rng, 0.1, state_dtype).items()}
    jcfg = jax_adamw.AdamWConfig(state_dtype=state_dtype,
                                 schedule=schedule and
                                 jax_adamw.warmup_cosine(*schedule),
                                 **cfg_kw)
    pcfg = adamw.AdamWConfig(state_dtype=state_dtype,
                             schedule=schedule and
                             adamw.warmup_cosine(*schedule), **cfg_kw)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    js = {"m": {k: jnp.asarray(a) for k, a in m.items()},
          "v": {k: jnp.asarray(a) for k, a in v.items()},
          "step": jnp.int32(4)}
    tp = {k: _to_torch(a) for k, a in params.items()}
    ts = {"m": {k: _to_torch(a) for k, a in m.items()},
          "v": {k: _to_torch(a) for k, a in v.items()},
          "step": torch.tensor(4, dtype=torch.int32)}
    out = []
    for _ in range(steps):
        g = _np_tree(rng, grad_scale)
        g = {k: g[k].astype(params[k].dtype) for k in g}
        jp, js, jm = jax_adamw.adamw_update(
            jp, {k: jnp.asarray(a) for k, a in g.items()}, js, jcfg)
        tp, ts, tm = adamw.adamw_update(
            tp, {k: _to_torch(a) for k, a in g.items()}, ts, pcfg)
        out.append((jax.device_get((jp, js, jm)), (tp, ts, tm)))
    return out


@pytest.mark.parametrize("schedule", [None, (5, 20)],
                         ids=["constant", "warmup_cosine"])
@pytest.mark.parametrize("grad_scale", [0.01, 30.0],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_is_the_references(state_dtype, grad_scale, schedule):
    exact = schedule is None and grad_scale < 1
    for (jp, js, jm), (tp, ts, tm) in _run_both(
            {"lr": 1e-2, "weight_decay": 0.1}, state_dtype, grad_scale,
            schedule):
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert _ulps(_to_np(tm["lr"]), np.asarray(jm["lr"])) <= \
            (0 if schedule is None else ULPS)
        for k in SHAPES:
            for got, want, what in ((tp[k], jp[k], "param"),
                                    (ts["m"][k], js["m"][k], "m"),
                                    (ts["v"][k], js["v"][k], "v")):
                got = _to_np(got)
                assert got.dtype == np.asarray(want).dtype, (k, what)
                if exact:
                    np.testing.assert_array_equal(
                        got.view(np.uint8), np.asarray(want).view(np.uint8),
                        err_msg=f"{what} {k}")
                else:
                    assert _ulps(got.astype(np.float32),
                                 np.asarray(want, np.float32)) <= ULPS, \
                        (what, k)


def test_no_decay_below_two_dims():
    """With a zero gradient the moments stay zero and only the decay
    moves a weight: leaves of 2 dims and more shrink, the others stay."""
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    cfg = adamw.AdamWConfig(lr=0.5, weight_decay=0.1)
    st = adamw.init_opt({"w": ParamSpec((3, 2), "float32"),
                         "b": ParamSpec((2,), "float32")}, cfg, "cpu")
    p2, _, _ = adamw.adamw_update(p, g, st, cfg)
    assert torch.equal(p2["b"], p["b"])
    assert torch.all(p2["w"] == torch.tensor(1 - 0.5 * 0.1,
                                             dtype=torch.float32))


def test_opt_specs_and_init_opt_mirror_the_reference():
    specs = {"a": ParamSpec((3, 4), axes=("fsdp", None)),
             "b": {"c": ParamSpec((5,), "float32", "ones", axes=(None,))}}
    jspecs = {"a": JaxParamSpec((3, 4), ("fsdp", None)),
              "b": {"c": JaxParamSpec((5,), (None,), "float32", "ones")}}
    for sd in ("float32", "bfloat16"):
        got = adamw.opt_specs(specs, adamw.AdamWConfig(state_dtype=sd))
        want = jax_adamw.opt_specs(jspecs,
                                   jax_adamw.AdamWConfig(state_dtype=sd))
        for part in ("m", "v"):
            for path in (("a",), ("b", "c")):
                g, w = got[part], want[part]
                for k in path:
                    g, w = g[k], w[k]
                assert (g.shape, g.dtype, g.init, g.axes) == \
                    (w.shape, w.dtype, w.init, w.axes)
        assert (got["step"].shape, got["step"].dtype) == ((), "int32")
        st = adamw.init_opt(specs, adamw.AdamWConfig(state_dtype=sd), "cpu")
        assert st["m"]["a"].dtype == getattr(torch, sd)
        assert not st["v"]["b"]["c"].any() and int(st["step"]) == 0
        assert st["step"].dtype == torch.int32


def test_warmup_cosine_is_the_references():
    f, jf = adamw.warmup_cosine(10, 100), jax_adamw.warmup_cosine(10, 100)
    steps = np.arange(0, 130, dtype=np.int32)
    got = f(torch.from_numpy(steps)).numpy()
    want = np.asarray(jf(jnp.asarray(steps)))
    assert _ulps(got, want) <= ULPS
    np.testing.assert_array_equal(got[:11], want[:11])  # the warm-up


def test_global_norm():
    rng = np.random.default_rng(3)
    tree = _np_tree(rng, 2.0)
    got = adamw.global_norm({k: _to_torch(a) for k, a in tree.items()})
    want = jax_adamw.global_norm({k: jnp.asarray(a)
                                  for k, a in tree.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=NORM_RTOL)


# the reference's own cases ------------------------------------------------
def test_adamw_minimizes_quadratic():
    specs = {"w": ParamSpec((8, 8), "float32")}
    params = {"w": torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal((8, 8))
                                    .astype(np.float32))}
    opt = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adamw.init_opt(specs, opt, "cpu")
    losses = []
    for _ in range(60):
        w = params["w"].detach().requires_grad_()
        loss = torch.sum((w - 1.0) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, state, _ = adamw.adamw_update(params, {"w": g}, state, opt)
        losses.append(float(loss))
    assert losses[-1] < 0.01 * losses[0]


def test_grad_clip_bounds_update():
    opt = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = adamw.init_opt({"w": ParamSpec((4,), "float32")}, opt, "cpu")
    p2, _, m = adamw.adamw_update({"w": torch.zeros(4)},
                                  {"w": torch.full((4,), 1e6)}, state, opt)
    assert float(m["grad_norm"]) > 1e5
    assert torch.isfinite(p2["w"]).all()


def test_warmup_cosine_schedule():
    f = adamw.warmup_cosine(10, 100)
    assert float(f(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(f(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(f(torch.tensor(100, dtype=torch.int32))) <= 0.11


def test_bf16_state_dtype():
    st = adamw.init_opt({"w": ParamSpec((4, 4))},
                        adamw.AdamWConfig(state_dtype="bfloat16"), "cpu")
    assert st["m"]["w"].dtype == torch.bfloat16


# compression ----------------------------------------------------------------
def _grads(rng, n: int = 257) -> np.ndarray:
    g = rng.standard_normal(n).astype(np.float32)
    g[:4] = [1.5, -2.5, 0.5, 127.0]     # half-way values after scaling
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_is_the_references(dtype):
    rng = np.random.default_rng(1)
    ef = np.zeros(257, np.float32)
    jef = jnp.asarray(ef)
    for step in range(5):
        g = _grads(rng)
        if step == 1:
            g = np.arange(-127, 130, dtype=np.float32)   # q = x exactly
        g = g.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                     else np.float32)
        q, s, ef_t = compression.compress(_to_torch(g), _to_torch(ef))
        jq, js, jef = jax_comp.compress(jnp.asarray(g), jef)
        assert q.dtype == torch.int8 and s.dim() == 0
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))
        np.testing.assert_array_equal(ef_t.numpy().view(np.uint32),
                                      np.asarray(jef).view(np.uint32))
        for out_dt, jdt in ((torch.float32, jnp.float32),
                            (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(
                _to_np(compression.decompress(q, s, out_dt)).view(np.uint8),
                np.asarray(jax_comp.decompress(jq, js, jdt)).view(np.uint8))
        ef = ef_t.numpy()


def test_round_half_to_even_on_the_int8_path():
    """A scale of 1 (max |g| = 127) leaves the half-way values as they
    are: both packages round 0.5, 1.5, 2.5, -2.5 to 0, 2, 2, -2."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5], np.float32)
    q, _, _ = compression.compress(torch.from_numpy(g), torch.zeros(7))
    jq, _, _ = jax_comp.compress(jnp.asarray(g), jnp.zeros(7))
    assert q.tolist() == [127, 0, 2, 2, -2, 0, 126] == np.asarray(jq).tolist()


def test_compress_tree_is_the_references():
    rng = np.random.default_rng(2)
    grads = {"a": _grads(rng, 33), "b": {"c": _grads(rng, 9)}}
    efs = {"a": np.full(33, 0.01, np.float32),
           "b": {"c": np.zeros(9, np.float32)}}
    t = lambda tree: jax.tree.map(_to_torch, tree)  # noqa: E731
    qs, ss, es = compression.compress_tree(t(grads), t(efs))
    jqs, jss, jes = jax_comp.compress_tree(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, efs))
    for got, want in ((qs, jqs), (ss, jss), (es, jes)):
        for path in (("a",), ("b", "c")):
            g, w = got, want
            for k in path:
                g, w = g[k], w[k]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    like = {"a": torch.zeros(33, dtype=torch.bfloat16),
            "b": {"c": torch.zeros(9)}}
    back = compression.decompress_tree(qs, ss, like)
    jback = jax_comp.decompress_tree(jqs, jss, {"a": jnp.zeros(
        33, jnp.bfloat16), "b": {"c": jnp.zeros(9)}})
    assert back["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_to_np(back["a"]).view(np.uint16),
                                  np.asarray(jback["a"]).view(np.uint16))
    np.testing.assert_array_equal(back["b"]["c"].numpy(),
                                  np.asarray(jback["b"]["c"]))


def test_compressed_psum_single_device(mesh):
    x = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    ef = np.zeros(16, np.float32)
    with jax.set_mesh(mesh):
        want, wef = jax_comp.compressed_psum(jnp.asarray(x), jnp.asarray(ef),
                                             mesh, axis="pod")
    got, gef = compression.compressed_psum(
        torch.from_numpy(x), torch.from_numpy(ef),
        make_test_mesh(device="cpu"), axis="pod")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gef.numpy(), np.asarray(wef))
    np.testing.assert_allclose(got.numpy(), x, atol=0.05)


def test_compressed_psum_axis_rules():
    """A ``pod`` axis repeated on one device sums its members' copies, as
    a replicated input's all-gather does; one over distinct devices is
    refused."""
    x = torch.linspace(-1, 1, 8)
    one, _ = compression.compressed_psum(x, torch.zeros(8),
                                         Mesh(("cpu",), ("pod",)))
    two, _ = compression.compressed_psum(x, torch.zeros(8),
                                         Mesh(("cpu", "cpu"), ("pod",)))
    torch.testing.assert_close(two, 2 * one, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="item 16"):
        compression.compressed_psum(x, torch.zeros(8),
                                    Mesh(("cpu", "meta"), ("pod",)))


def test_compression_error_feedback_unbiased():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                         .astype(np.float32))
    ef, total = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        q, s, ef = compression.compress(g, ef)
        total = total + compression.decompress(q, s)
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=0.02)
