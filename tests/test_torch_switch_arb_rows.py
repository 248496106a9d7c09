"""The port's arbitration on the engine's flat requester rows, bitwise.

``switch_arbitrate_rows`` (occupancy read from the queue state, credit,
scores, first argmin and the segmented output arbitration on the flat
rows ``[N*P network inputs] ++ [NICs]``) against

* the reference's adapter ``repro.kernels.switch_arb.ops.
  switch_arbitrate_flat`` (the Pallas kernel in interpret mode), fed the
  occupancy, credit and mask that ``src/repro/simulator/engine.py``'s
  crossbar round computes, with the reference simulator's own geometry;
* the port's previous path: the same engine lines in torch and
  ``ops.switch_arbitrate_flat`` on the dense layout.

Fabrics: the golden ``mrls(14, 3, 3)``, a small ``fat_tree``, whose
spines have no NICs, ``dragonfly(4, 2, 2)`` (every switch a leaf, P = 5,
so rows are not 16-byte aligned) and ``dragonfly_plus(5, 4, 4, 4, 4)``
(half of each leaf's ports unlinked).  States: output queues 0 to OQ (full ones have no
credit), allowed-port densities 0, 0.3 and 1, tiebreaks on four levels
(equal scores resolve to the lowest port), priorities in [0, 4) (the row
index decides).  ``vc_prearb``'s head-packet gather against the
reference's ``vc_prearb_op`` and the engine's gather, in its crossbar
and link-phase forms.  Tolerance: zero (integer outputs).  The CUDA
kernels are held to these plain versions by the ``gpu``-marked test,
which runs only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as port_core
from repro.kernels.switch_arb import ops as jax_ops
from repro.simulator.engine import SimConfig as JaxConfig
from repro.simulator.engine import Simulator as JaxSimulator
from repro_torch.kernels.switch_arb import bench, kernel, ops, ref
from repro_torch.simulator.engine import SimConfig, Simulator

FABRICS = {"mrls": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
           "fat_tree": ("fat_tree", dict(radix=6, h=2)),
           "dragonfly": ("dragonfly", dict(a=4, p=2, h=2)),
           "dragonfly_plus": ("dragonfly_plus", dict(
               n_groups=5, leaves_per_group=4, spines_per_group=4, p=4,
               global_per_spine=4))}
POLICIES = ("polarized", "minimal_adaptive", "ksp")
DENSITIES = (0.0, 0.3, 1.0)
V, Q, OQ, PENALTY = 4, 8, 4, 8.0
CASES = [(f, pol, dens) for f in FABRICS for pol in POLICIES
         for dens in DENSITIES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread is as fast and leaves
    the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fabrics():
    """``{fabric: (reference geometry, port simulator, port topology)}``;
    the reference geometry is its simulator's ``cur``, ``_dq_perm``,
    ``_row_of``, ``_lo`` and ``R_max``."""
    out = {}
    for name, (family, params) in FABRICS.items():
        jtopo = getattr(jax_core, family)(**params)
        with JaxSimulator(jax_core.build_tables(jtopo),
                          JaxConfig(max_hops=10, pool=4096)) as js:
            geo = dict(cur=js.cur, dq_perm=js._dq_perm, row_of=js._row_of,
                       lo=js._lo, r_max=js.R_max)
        ptopo = getattr(port_core, family)(**params)
        sim = Simulator(port_core.build_tables(ptopo, device="cpu"),
                        SimConfig(max_hops=10, pool=4096), device="cpu")
        out[name] = (geo, sim, ptopo)
    return out


def _state(sim, seed: int, density: float, policy: str) -> dict:
    """A seeded queue state and requester table of ``sim``'s shapes, as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    nr, p, nq = sim.NR, sim.P, sim.NQ
    tie = np.floor(rng.random((nr, p)) * 4).astype(np.float32) / 4
    deroute = rng.random((nr, p)) < 0.5
    if policy == "minimal_adaptive":    # as the engine gives it
        deroute = np.zeros_like(deroute)
    return dict(tie=tie, allowed=rng.random((nr, p)) < density,
                deroute=deroute, route=rng.random(nr) < 0.8,
                rnd=rng.integers(0, 4, nr, dtype=np.int32),
                next_vc=rng.integers(0, V, nr, dtype=np.int32),
                oq_len=rng.integers(0, OQ + 1, nq, dtype=np.int32),
                qlen=rng.integers(0, Q + 1, nq, dtype=np.int32))


_ARGS = ("tie", "allowed", "deroute", "route", "rnd", "next_vc", "oq_len",
         "qlen")


def _rows(sim, st: dict, policy: str):
    """The port's ``switch_arbitrate_rows`` on CPU tensors."""
    return ops.switch_arbitrate_rows(
        *(torch.as_tensor(st[k]) for k in _ARGS),
        nic_first=sim._nic_first, dq_base=sim._dq_base, d=sim.d_leaf,
        penalty=PENALTY, out_queue=OQ, zero_occ=policy == "ksp")


def _reference(geo: dict, n: int, p: int, st: dict, policy: str):
    """The reference engine's crossbar-round lines (occupancy, credit,
    mask, the ksp zeros) in jnp, then its Pallas adapter."""
    oq_v = jnp.asarray(st["oq_len"]).reshape(n, p, V).transpose(
        0, 2, 1).reshape(n * V, p)
    qd_v = jnp.asarray(st["qlen"])[geo["dq_perm"]].reshape(n * V, p)
    occ_row = geo["cur"] * V + jnp.asarray(st["next_vc"])
    oq_occ = oq_v[occ_row]
    occ = oq_occ + qd_v[occ_row]
    mask = jnp.asarray(st["allowed"]) & (oq_occ < OQ)
    deroute = jnp.asarray(st["deroute"])
    if policy == "ksp":
        occ, deroute = jnp.zeros_like(occ), jnp.zeros_like(deroute)
    out = jax_ops.switch_arbitrate_flat(
        occ, deroute, mask, jnp.asarray(st["tie"]), jnp.asarray(st["route"]),
        jnp.asarray(st["rnd"]), geo["lo"], penalty=PENALTY,
        row_of=geo["row_of"], n_switches=n, r_max=geo["r_max"])
    return [np.asarray(x).astype(np.int32) for x in out]


def _old_path(sim, topo, st: dict, policy: str):
    """The port's previous crossbar-round lines: the V-major occupancy
    gathers built from the topology, then the dense adapter."""
    n, p = sim.N, sim.P
    nbrs, nbr_port = np.asarray(topo.nbrs), np.asarray(topo.nbr_port)
    dq_perm = torch.as_tensor(
        ((np.maximum(nbrs, 0) * p + np.maximum(nbr_port, 0))[:, None, :] * V
         + np.arange(V)[None, :, None]).reshape(-1).astype(np.int64))
    t = {k: torch.as_tensor(v) for k, v in st.items()}
    oq_v = t["oq_len"].reshape(n, p, V).transpose(1, 2).reshape(n * V, p)
    qd_v = t["qlen"][dq_perm].reshape(n * V, p)
    occ_row = sim.cur * V + t["next_vc"]
    oq_occ = oq_v[occ_row]
    occ = oq_occ + qd_v[occ_row]
    mask = t["allowed"] & (oq_occ < OQ)
    deroute = t["deroute"]
    if policy == "ksp":
        occ, deroute = torch.zeros_like(occ), torch.zeros_like(deroute)
    i32 = torch.int32
    return ops.switch_arbitrate_flat(
        occ, deroute.to(i32), mask.to(i32), t["tie"], t["route"].to(i32),
        t["rnd"], torch.arange(sim.NR, dtype=i32), penalty=PENALTY,
        row_of=sim._row_of, n_switches=n, r_max=sim.R_max)


def _seed(fabric: str, policy: str, density: float) -> int:
    return (list(FABRICS).index(fabric) * 100 + POLICIES.index(policy) * 10
            + DENSITIES.index(density))


@pytest.mark.parametrize("fabric,policy,density", CASES, ids=str)
def test_rows_match_the_reference_adapter(fabrics, fabric, policy,
                                          density):
    geo, sim, _ = fabrics[fabric]
    st = _state(sim, _seed(fabric, policy, density), density, policy)
    got = _rows(sim, st, policy)
    want = _reference(geo, sim.N, sim.P, st, policy)
    assert [g.shape for g in got] == [(sim.NR,), (sim.NR,),
                                      (sim.N * sim.P,)]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # the case decides something: grants where ports are allowed
    assert (got[1].sum() > 0) == (density > 0)


@pytest.mark.parametrize("fabric,policy,density", CASES, ids=str)
def test_rows_match_the_ports_old_path(fabrics, fabric, policy, density):
    _, sim, topo = fabrics[fabric]
    st = _state(sim, 1000 + _seed(fabric, policy, density), density, policy)
    got = _rows(sim, st, policy)
    want = _old_path(sim, topo, st, policy)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.int32))


@pytest.mark.parametrize("fabric", list(FABRICS))
def test_geometry_matches_the_reference_simulator(fabrics, fabric):
    """nic_first / dq_base encode the reference's requester rows and its
    V-major downstream-queue permutation."""
    geo, sim, _ = fabrics[fabric]
    n, p = sim.N, sim.P
    dq_perm = (sim._dq_base.reshape(n, 1, p)
               + torch.arange(V, dtype=torch.int32).reshape(1, V, 1))
    np.testing.assert_array_equal(dq_perm.reshape(-1).numpy(),
                                  np.asarray(geo["dq_perm"]))
    cur = np.asarray(geo["cur"])
    nic_first = sim._nic_first.numpy()
    for sw in range(n):
        rows = np.nonzero(cur[n * p:] == sw)[0] + n * p
        if nic_first[sw] < 0:
            assert rows.size == 0
        else:
            np.testing.assert_array_equal(
                rows, nic_first[sw] + np.arange(sim.d_leaf))


@pytest.mark.parametrize("form", ["crossbar", "link"])
@pytest.mark.parametrize("n,p,v", [(21, 6, 4), (5, 7, 3), (9, 16, 8)],
                         ids=str)
def test_vc_prearb_gather_matches_reference(form, n, p, v):
    """The reference's ``vc_prearb_op`` and the engine's head gather: in
    the crossbar round from the input queues (qlen counts, depth Q), in
    the link phase from the output queues (0/1 candidates, depth OQ)."""
    rng = np.random.default_rng(n * 10 + p + (form == "link"))
    depth = Q if form == "crossbar" else OQ
    hi = Q + 1 if form == "crossbar" else 2
    qlen = rng.integers(0, hi, (n, p, v), dtype=np.int32)
    rand = np.floor(rng.random((n, p, v)) * 4).astype(np.float32) / 4
    buf = rng.integers(-1, 5000, (n * p * v, depth), dtype=np.int32)
    head = rng.integers(0, depth, n * p * v, dtype=np.int32)

    sel, has = jax_ops.vc_prearb_op(jnp.asarray(qlen), jnp.asarray(rand))
    q_idx = (jnp.arange(n * p, dtype=jnp.int32).reshape(n, p) * v
             + sel.astype(jnp.int32)).reshape(-1)
    hd = jnp.asarray(buf).reshape(-1)[q_idx * depth + jnp.asarray(head)[q_idx]]
    want_pkt = np.asarray(jnp.where(has.reshape(-1), hd, -1))

    got = ops.vc_prearb(*(torch.as_tensor(a) for a in (qlen, rand, buf,
                                                       head)))
    assert len(got) == 3 and all(g.dtype == torch.int32 for g in got)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(sel))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(has).astype(np.int32))
    np.testing.assert_array_equal(got[2].reshape(-1).numpy(), want_pkt)
    if form == "link":
        # the engine clamps: a sender's packet is the reference's clamped
        # head, a non-sender carries 0 (nothing reads it)
        send = np.asarray(has).reshape(-1)
        pkt0 = got[2].reshape(-1).clamp(min=0).numpy()
        np.testing.assert_array_equal(pkt0[send],
                                      np.maximum(np.asarray(hd), 0)[send])
        assert (pkt0[~send] == 0).all()


def _small_rows(nr=9, p=3, n=2):
    """Valid CPU inputs with N=2, P=3, d=3 (NR = 9: one leaf)."""
    gen = torch.Generator().manual_seed(5)
    args = [torch.rand((nr, p), generator=gen),
            torch.rand((nr, p), generator=gen) < 0.5,
            torch.zeros((nr, p), dtype=torch.bool),
            torch.ones(nr, dtype=torch.bool),
            torch.randint(0, 256, (nr,), generator=gen, dtype=torch.int32),
            torch.zeros(nr, dtype=torch.int32),
            torch.zeros(n * p * V, dtype=torch.int32),
            torch.zeros(n * p * V, dtype=torch.int32)]
    kw = dict(nic_first=torch.tensor([6, -1], dtype=torch.int32),
              dq_base=torch.zeros(n * p, dtype=torch.int32), d=3,
              penalty=PENALTY, out_queue=OQ)
    return args, kw


def test_cpu_tensors_take_the_plain_version():
    args, kw = _small_rows()
    for g, w in zip(ops.switch_arbitrate_rows(*args, **kw),
                    ref.switch_arbitrate_rows_ref(*args, **kw)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.switch_arbitrate_rows(*args, **kw)
    qlen = torch.ones((2, 3, V), dtype=torch.int32)
    rand = torch.rand((2, 3, V))
    buf = torch.arange(2 * 3 * V * Q, dtype=torch.int32).reshape(-1, Q)
    head = torch.zeros(2 * 3 * V, dtype=torch.int32)
    for g, w in zip(ops.vc_prearb(qlen, rand, buf, head),
                    ref.vc_prearb_ref(qlen, rand, buf, head)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.vc_prearb(qlen, rand, buf, head)


def _bad(name: str):
    args, kw = _small_rows()
    i = _ARGS.index(name) if name in _ARGS else None
    if name == "rows":
        # 2**23 rows: views, so nothing is allocated
        nr = kernel.MAX_ROWS
        args[0] = torch.zeros(1, 3).expand(nr, 3)
    elif name == "tie":
        args[i] = args[i].double()
    elif name in ("allowed", "deroute", "route"):
        args[i] = args[i].to(torch.int32)
    elif name == "rnd":
        args[i] = args[i].long()
    elif name == "qlen":
        args[i] = args[i][:-1]
    elif name == "strided":
        args[0] = args[0].t().contiguous().t()
    elif name == "nic_first":
        kw["nic_first"] = kw["nic_first"].long()
    return args, kw


@pytest.mark.parametrize("name,error", [
    ("rows", ValueError), ("tie", TypeError), ("allowed", TypeError),
    ("deroute", TypeError), ("route", TypeError), ("rnd", TypeError),
    ("qlen", ValueError), ("strided", ValueError),
    ("nic_first", TypeError)])
def test_bad_inputs_raise(name, error):
    args, kw = _bad(name)
    with pytest.raises(error, match="2\\*\\*23" if name == "rows" else None):
        ops.switch_arbitrate_rows(*args, **kw)


def test_fig5_bound_counts_the_bytes_moved():
    """The bench's bytes at Figure 5 (N = 921, P = 36, NR = 44,208):
    tie, two mask bytes, row vectors, occupancy words, outputs."""
    geo = bench.geometry("fig5", "cpu")
    assert (geo.n, geo.p, geo.d, geo.nr) == (921, 36, 18, 44_208)
    assert bench.rows_bytes(geo) == 11_630_388
    assert bench.dense_bytes(geo.n, geo.p + geo.d, geo.p) == 29_774_088
    assert bench.vc_bytes(geo.n * geo.p, V, geo.n * geo.p) == 52 * 33_156


def test_replica_bound_counts_the_shared_geometry_once():
    """At R = 4 the per-replica arrays count four times and the geometry
    the replicas share (``nic_first`` [N], ``dq_base`` [N*P]) once."""
    geo = bench.geometry("fig5", "cpu")
    shared = geo.n * 4 + geo.n * geo.p * 4
    assert shared == 136_308
    assert bench.rows_bytes(geo, replicas=4) == 4 * 11_630_388 - 3 * shared
    assert bench.rows_bytes(geo, replicas=4) == 46_112_628
    assert (bench.rows_bytes(geo, zero_occ=True, replicas=4)
            == 4 * bench.rows_bytes(geo, zero_occ=True) - 3 * geo.n * 4)


@pytest.mark.parametrize("label,shape", [
    ("df", (2064, 23, 8, 63_984)), ("dfplus", (2080, 32, 16, 83_200))])
def test_fig7_geometries_take_the_plain_version(label, shape):
    """Figure 7's Dragonfly (P = 23, odd) and Dragonfly+ (P = 32, d = 16)
    pass the kernel's input checks and run the plain version on the
    bench's seeded inputs: grants only where a port is allowed and has
    credit, at most one a (switch, out-port)."""
    geo = bench.geometry(label, "cpu")
    assert (geo.n, geo.p, geo.d, geo.nr) == shape
    # ugal and valiant feed the kernel as minimal_adaptive does (no
    # deroutes), with next_vc over 0 .. V-1
    args, kw = bench.rows_inputs(geo, torch.Generator().manual_seed(19),
                                 0.3, "minimal_adaptive")
    assert kernel.rows_geometry(*args, kw["nic_first"], kw["dq_base"],
                                kw["d"]) == (geo.n, geo.p, V, geo.nr)
    port, win, seg = ops.switch_arbitrate_rows(*args, **kw)
    won = win > 0
    assert won.any() and (port[won] >= 0).all()
    assert int(won.sum()) == int((seg >= 0).sum())
    assert args[1][won].any(dim=1).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_bench_inputs_take_the_plain_version(policy):
    """The bench's seeded inputs on the golden fabric: the plain version
    agrees with the old path's dense adapter."""
    geo = bench.geometry("golden", "cpu")
    args, kw = bench.rows_inputs(geo, torch.Generator().manual_seed(3),
                                 0.3, policy)
    got = ops.switch_arbitrate_rows(*args, **kw)
    tables = port_core.build_tables(port_core.mrls(**FABRICS["mrls"][1]),
                                    device="cpu")
    sim = Simulator(tables, SimConfig(), device="cpu")
    st = {k: a.numpy() for k, a in zip(_ARGS, args)}
    want = _old_path(sim, tables.topo, st, policy)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["golden", "fig5", "df", "dfplus"])
def test_cuda_kernels_match_plain_versions(label):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    geo = bench.geometry(label, dev)
    errs = bench.run_cases({label: geo},
                           torch.Generator(device=dev).manual_seed(7))
    assert errs == {"switch_arbitrate_rows": 0, "switch_arbitrate": 0,
                    "vc_prearb": 0}


# ---------------------------------------------------------------------- #
# the replica axis
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("label", ["golden", "df"])
def test_rows_with_replicas_equal_one_call_a_replica(label, policy):
    """``switch_arbitrate_rows_ref`` at R = 3 (a different seeded state a
    replica) equals three unbatched calls: each replica's priority words
    hold its rows' indices within its own fabric."""
    geo = bench.geometry(label, "cpu")
    args, kw, per = bench.replica_inputs(
        geo, torch.Generator().manual_seed(11), 3, policy)
    got = ops.switch_arbitrate_rows(*args, **kw)
    assert [tuple(g.shape) for g in got] == [
        (3, geo.nr), (3, geo.nr), (3, geo.n * geo.p)]
    for i, one in enumerate(per):
        for g, w in zip(got, ops.switch_arbitrate_rows(*one, **kw)):
            assert torch.equal(g[i], w)
    assert kernel.rows_geometry(*args, kw["nic_first"], kw["dq_base"],
                                kw["d"]) == (geo.n, geo.p, V, geo.nr)


def test_rows_with_replicas_check_every_input():
    geo = bench.geometry("golden", "cpu")
    args, kw, _ = bench.replica_inputs(geo, torch.Generator().manual_seed(2),
                                       2)
    for i, name in enumerate(_ARGS):
        bad = list(args)
        bad[i] = bad[i][0]              # one input without the replica axis
        # tie sets the layout; any other input is named
        with pytest.raises(ValueError,
                           match="has shape" if i == 0 else name):
            ops.switch_arbitrate_rows(*bad, **kw)


def test_vc_prearb_replicas_go_through_as_switches():
    """R stacked ``[N, P, V]`` states and their ``[N*P*V, depth]`` buffers
    through ``vc_prearb`` as ``R*N`` switches: each replica's rows are its
    own call's, the head gather included."""
    gen = torch.Generator().manual_seed(5)
    n, p = 21, 6
    states = [bench.vc_inputs(gen, n, p, V, Q) for _ in range(3)]
    qlen, rand, buf, head = (torch.stack(xs) for xs in zip(*states))
    got = ops.vc_prearb(qlen.reshape(3 * n, p, V), rand.reshape(3 * n, p, V),
                        buf.reshape(-1, Q), head.reshape(-1))
    for i, st in enumerate(states):
        for g, w in zip(got, ops.vc_prearb(*st)):
            assert torch.equal(g[i * n:(i + 1) * n], w)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["golden", "fig5"])
def test_cuda_kernels_with_replicas_match_plain_versions(label):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    errs = bench.run_replica_cases(
        bench.geometry(label, dev), torch.Generator(device=dev).manual_seed(7))
    assert errs == {"switch_arbitrate_rows": 0, "vc_prearb": 0}
