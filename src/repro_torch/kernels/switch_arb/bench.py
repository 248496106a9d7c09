"""The crossbar arbitration kernels alone on the card: build, check, time.

Run from the root of a checkout on a host with one NVIDIA H100:

    PYTHONPATH=src python3 -m repro_torch.kernels.switch_arb.bench

It builds only ``switch_arb`` (``_build.build_all(["switch_arb"])``, with
``nvcc``'s ``-Xptxas -v`` report) and then:

1. counts ``LDG.E.128``, ``LDGSTS``, ``SHFL`` and other instructions in
   each kernel function of the built library (``cuobjdump -sass``);
2. holds every kernel bitwise to its plain version on the cases of
   :func:`run_cases`: ``switch_arbitrate_rows`` with each number of lanes
   a row of ``kernel.ROWS_LANES`` on seeded queue states of the golden
   fabric ``mrls(14, 3, 3)``, Figure 5's ``mrls(614, 18, 18)``, the
   Figure-6 Fat-Tree ``fat_tree(36, 3, a1=18)`` (whose spines have no
   NICs), and Figure 7's ``dragonfly(16, 8, 8)`` (P = 23: rows not
   16-byte aligned) and ``dragonfly_plus(65, 16, 16, 16, 16)`` (P = 32,
   d = 16, half of each leaf's ports unlinked), under the three
   policies' settings (UGAL and Valiant give the kernel
   minimal_adaptive's) at allowed-port densities
   0, 0.3 and 1, with tiebreaks on four levels and colliding priorities;
   the dense ``switch_arbitrate``; ``vc_prearb`` with and without its
   head-packet gather, at the Figure-5 and Figure-7 shapes (V = 4) and at
   other V; then both engine kernels at 4 replicas
   (:func:`run_replica_cases`) on the golden and Figure-5 geometries, a
   different seeded state a replica, against their plain versions and
   against one unbatched launch a replica;
3. times, at the Figure-5, Fat-Tree, Dragonfly and Dragonfly+
   geometries, the dense kernel,
   ``switch_arbitrate_rows`` with each number of lanes a row,
   ``vc_prearb`` with and without the gather and an empty kernel: back to
   back by CUDA events (the C entry point on preallocated outputs) and
   each launch's own device time from ``torch.profiler``; beside each,
   the bound from the shapes; and the two engine kernels at 4 replicas
   on the Figure-5 geometry (:func:`time_replicas`).

It exits with 1 if any kernel differs from its plain version in any bit.
``chip_smoke.py`` phase 3 calls :func:`geometry`, :func:`run_cases` and
:func:`time_point`, so the cases and the bounds live here.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import faulthandler
import json
import re
import subprocess
import sys
import time
from typing import Optional

import torch

from .. import _build
from ..flash_attention.bench import HBM_BYTES_PER_S, cuda_ms
from ..minplus.bench import _sass
from ..selective_scan.bench import _INSN
from . import kernel, ref
from .ops import flat_rows_geometry

__all__ = ["Geometry", "geometry", "GEOMETRIES", "rows_inputs",
           "rows_bytes", "rows_label", "run_cases", "time_point",
           "replica_inputs", "run_replica_cases", "time_replicas",
           "sass_counts", "main"]

# the fabrics (functions of repro_torch.core) and the engine's defaults
GEOMETRIES = {"golden": ("mrls", dict(n_leaves=14, u=3, d=3, seed=0)),
              "fig5": ("mrls", dict(n_leaves=614, u=18, d=18, seed=1)),
              "ft50": ("fat_tree", dict(radix=36, h=3, a1=18)),
              "df": ("dragonfly", dict(a=16, p=8, h=8)),
              "dfplus": ("dragonfly_plus", dict(
                  n_groups=65, leaves_per_group=16, spines_per_group=16,
                  p=16, global_per_spine=16))}
V, Q, OQ, PENALTY = 4, 8, 4, 8.0
POLICIES = ("polarized", "minimal_adaptive", "ksp")
DENSITIES = (0.0, 0.3, 1.0)
TIE_LEVELS = 4                   # coarse tiebreaks: many equal scores


@dataclasses.dataclass
class Geometry:
    label: str
    n: int                       # switches
    p: int                       # ports a switch
    d: int                       # NICs a leaf
    nr: int                      # flat requester rows
    nic_first: torch.Tensor      # int32 [N]
    dq_base: torch.Tensor        # int32 [N*P]


def geometry(label: str, device) -> Geometry:
    """The flat-row geometry of ``GEOMETRIES[label]`` on ``device``."""
    from ... import core
    family, params = GEOMETRIES[label]
    topo = getattr(core, family)(**params)
    d = topo.endpoints_per_leaf
    nic_first, dq_base = flat_rows_geometry(topo.nbrs, topo.nbr_port,
                                            topo.leaf_ids, d, V)
    n, p = topo.n_switches, topo.max_ports
    return Geometry(label, n, p, d, n * p + topo.n_endpoints,
                    torch.as_tensor(nic_first, device=device),
                    torch.as_tensor(dq_base, device=device))


def rows_inputs(geo: Geometry, gen: torch.Generator, density: float,
                policy: str):
    """``(args, kw)`` of ``switch_arbitrate_rows`` on ``gen``'s device: a
    seeded queue state (output queues 0 to OQ, so some have no credit;
    input queues 0 to Q), ties on ``TIE_LEVELS`` levels, allowed ports at
    ``density``, deroutes at one half (none for minimal_adaptive, as the
    engine gives), priorities in [0, 4) so the row index decides."""
    dev = gen.device
    nr, p, nq = geo.nr, geo.p, geo.n * geo.p * V

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    tie = torch.floor(rand(nr, p) * TIE_LEVELS) / TIE_LEVELS
    allowed = rand(nr, p) < density
    deroute = rand(nr, p) < 0.5
    if policy == "minimal_adaptive":
        deroute = torch.zeros_like(deroute)
    args = (tie, allowed, deroute, rand(nr) < 0.8, ints(4, nr),
            ints(V, nr), ints(OQ + 1, nq), ints(Q + 1, nq))
    kw = dict(nic_first=geo.nic_first, dq_base=geo.dq_base, d=geo.d,
              penalty=PENALTY, out_queue=OQ, zero_occ=policy == "ksp")
    return args, kw


def rows_bytes(geo: Geometry, zero_occ: bool = False,
               replicas: int = 1) -> int:
    """Bytes ``switch_arbitrate_rows`` must move: tie, allowed, deroute
    (6 a row and port), route, rnd, next_vc (9 a row), oq_len and
    nic_first, qlen and dq_base unless ``zero_occ``, then port, win and
    seg out. At ``replicas`` every array but the geometry (``nic_first``,
    ``dq_base``), which the replicas share, is counted once a replica."""
    nr, np_, nq = geo.nr, geo.n * geo.p, geo.n * geo.p * V
    shared = geo.n * 4 + (0 if zero_occ else np_ * 4)
    occ = nq * 4 + (0 if zero_occ else nq * 4)
    per_replica = nr * geo.p * 6 + nr * 9 + occ + nr * 8 + np_ * 4
    return replicas * per_replica + shared


def dense_bytes(n: int, r: int, p: int) -> int:
    """Bytes of the dense kernel: occ, deroute, mask, tie (16 a row and
    port), route, rnd, lo in, port and win out, seg out."""
    return n * r * p * 16 + n * r * 12 + n * r * 8 + n * p * 4


def vc_bytes(rows: int, v: int, n_has: Optional[int] = None) -> int:
    """Bytes of ``vc_prearb``: qlen and rand in, sel and has out; with the
    gather (``n_has`` rows that have a candidate) the packet out and a
    head and a buffer word for each of those rows."""
    b = rows * (8 * v + 8)
    return b if n_has is None else b + rows * 4 + n_has * 8


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def dense_inputs(gen: torch.Generator, n: int, r: int, p: int):
    dev = gen.device

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return (ints(0, 12, n, r, p), ints(0, 2, n, r, p), ints(0, 2, n, r, p),
            torch.rand((n, r, p), generator=gen, device=dev),
            ints(0, 2, n, r), ints(0, 256, n, r),
            torch.arange(n * r, dtype=torch.int32, device=dev).reshape(n, r))


def vc_inputs(gen: torch.Generator, n: int, p: int, v: int, depth: int):
    """qlen in [0, 3), rand, and a queue buffer of ``depth`` packet ids
    with its heads."""
    dev = gen.device
    nq = n * p * v
    return (torch.randint(0, 3, (n, p, v), generator=gen, device=dev,
                          dtype=torch.int32),
            torch.rand((n, p, v), generator=gen, device=dev),
            torch.randint(-1, 1 << 20, (nq, depth), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.randint(0, depth, (nq,), generator=gen, device=dev,
                          dtype=torch.int32))


def _max_err(got, want) -> int:
    """Largest absolute difference over the outputs."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _hold(label: str, got, want) -> int:
    torch.cuda.synchronize()
    err = _max_err(got, want)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"{label}: max_abs_err {err}, "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}", flush=True)
    if not same:
        raise AssertionError(f"{label} differs from its plain version")
    return err


def run_cases(geos: dict, gen: torch.Generator) -> dict:
    """Every kernel against its plain version, bitwise, on the card:
    ``switch_arbitrate_rows`` (each lanes a row) on every geometry of
    ``geos`` x policy x density; the dense kernel at the Figure-5 shape
    and ragged ones; ``vc_prearb`` with and without the gather.  Raises
    on the first difference.  Returns ``{kernel name: max_abs_err}``."""
    errs = collections.defaultdict(int)
    for geo in geos.values():
        for policy in POLICIES:
            for density in DENSITIES:
                args, kw = rows_inputs(geo, gen, density, policy)
                want = ref.switch_arbitrate_rows_ref(*args, **kw)
                for m in kernel.ROWS_LANES:
                    got = kernel.switch_arbitrate_rows(*args, **kw,
                                                       lanes=m)
                    errs["switch_arbitrate_rows"] = max(
                        errs["switch_arbitrate_rows"],
                        _hold(f"switch_arbitrate_rows {geo.label} NR="
                              f"{geo.nr} P={geo.p} {policy} density "
                              f"{density} ({m} lanes a row)", got, want))
                del args, want, got
    fig5 = geos.get("fig5")
    dense = [(fig5.n, fig5.p + fig5.d, fig5.p)] if fig5 else []
    for n, r, p in dense + [(5, 9, 7), (3, 300, 290)]:
        args = dense_inputs(gen, n, r, p)
        errs["switch_arbitrate"] = max(errs["switch_arbitrate"], _hold(
            f"switch_arbitrate [{n},{r},{p}]",
            kernel.switch_arbitrate(*args, penalty=PENALTY),
            ref.switch_arbitrate_ref(*args, penalty=PENALTY)))
    # vc_prearb at the main paths' shapes: Figure 5 and Figure 7's
    # Dragonfly and Dragonfly+
    vc = [(g.n, g.p, V) for label, g in geos.items()
          if label in ("fig5", "df", "dfplus")]
    for n, p, v in vc + [(5, 7, 3), (9, 16, 8), (7, 5, 4)]:
        for depth in (Q, OQ):
            qlen, rand, buf, head = vc_inputs(gen, n, p, v, depth)
            for gather in (False, True):
                extra = (buf, head) if gather else ()
                errs["vc_prearb"] = max(errs["vc_prearb"], _hold(
                    f"vc_prearb [{n},{p},{v}]"
                    + (f" + gather from depth {depth}" if gather else ""),
                    kernel.vc_prearb(qlen, rand, *extra),
                    ref.vc_prearb_ref(qlen, rand, *extra)))
    return dict(errs)


def replica_inputs(geo: Geometry, gen: torch.Generator, replicas: int,
                   policy: str = "polarized", density: float = 0.3):
    """``(args, kw, per)`` of a batched ``switch_arbitrate_rows`` call:
    ``replicas`` seeded states of :func:`rows_inputs`, a different one a
    replica, stacked on a leading axis; ``per`` holds each replica's own
    ``args``."""
    per = [rows_inputs(geo, gen, density, policy)[0]
           for _ in range(replicas)]
    kw = rows_inputs(geo, gen, density, policy)[1]
    args = tuple(torch.stack(xs) for xs in zip(*per))
    return args, kw, per


def run_replica_cases(geo: Geometry, gen: torch.Generator,
                      replicas: int = 4) -> dict:
    """The crossbar kernels with a replica axis, bitwise on the card:
    ``switch_arbitrate_rows`` (the engine's lanes a row) at ``replicas``
    on seeded states of ``geo``, a different state a replica, under each
    policy's settings against its plain version and against one
    unbatched launch a replica; ``vc_prearb`` with its gather on
    ``replicas`` stacked states (``R*N`` switches) against its plain
    version and the unbatched launches.  Raises on the first difference;
    returns ``{kernel name: max_abs_err}``."""
    errs = collections.defaultdict(int)
    name = "switch_arbitrate_rows"
    for policy in POLICIES:
        args, kw, per = replica_inputs(geo, gen, replicas, policy)
        got = kernel.switch_arbitrate_rows(*args, **kw)
        want = ref.switch_arbitrate_rows_ref(*args, **kw)
        label = f"{name} {geo.label} R={replicas} {policy}"
        errs[name] = max(errs[name], _hold(f"{label} vs plain", got, want))
        singles = [kernel.switch_arbitrate_rows(*a, **kw) for a in per]
        errs[name] = max(errs[name], _hold(
            f"{label} vs {replicas} unbatched launches", got,
            [torch.stack(xs) for xs in zip(*singles)]))
        del args, per, got, want, singles
    n, p = geo.n, geo.p
    states = [vc_inputs(gen, n, p, V, Q) for _ in range(replicas)]
    qlen, rand, buf, head = (torch.stack(xs) for xs in zip(*states))
    got = kernel.vc_prearb(qlen.reshape(replicas * n, p, V),
                           rand.reshape(replicas * n, p, V),
                           buf.reshape(-1, Q), head.reshape(-1))
    label = f"vc_prearb + gather {geo.label} R={replicas} ({replicas}*N rows)"
    errs["vc_prearb"] = _hold(f"{label} vs plain", got, ref.vc_prearb_ref(
        qlen.reshape(replicas * n, p, V), rand.reshape(replicas * n, p, V),
        buf.reshape(-1, Q), head.reshape(-1)))
    singles = [kernel.vc_prearb(*st) for st in states]
    errs["vc_prearb"] = max(errs["vc_prearb"], _hold(
        f"{label} vs {replicas} unbatched launches", got,
        [torch.cat(xs) for xs in zip(*singles)]))
    return dict(errs)


def time_replicas(geo: Geometry, gen: torch.Generator, replicas: int = 4,
                  iters: int = 200, plain_iters: int = 20) -> dict:
    """Per-launch times of the engine's two crossbar kernels at
    ``replicas`` on ``geo`` (polarized, density 0.3), through the
    wrappers: ``{kernel name: {"ms", "device_ms", "plain_ms",
    "bound_ms", "bytes"}}``, the bound from ``replicas`` times one
    replica's bytes and the shared geometry once."""
    out = {}

    def rec(name, launch, n_bytes, plain):
        r = dict(ms=cuda_ms(launch, iters=iters, warmup=20),
                 device_ms=device_ms(launch, f"{name}_kernel"),
                 plain_ms=cuda_ms(plain, iters=plain_iters, warmup=2),
                 bound_ms=bound_ms(n_bytes), bytes=n_bytes)
        out[name] = r
        print(f"{geo.label} {name} R={replicas}: {r['ms'] * 1e3:.3f} us back "
              f"to back, {(r['device_ms'] or 0) * 1e3:.3f} us on the device "
              f"(profiler); bound {r['bound_ms'] * 1e3:.3f} us ({n_bytes} "
              f"bytes); plain {r['plain_ms']:.6f} ms", flush=True)

    args, kw, _ = replica_inputs(geo, gen, replicas)
    rec("switch_arbitrate_rows",
        lambda: kernel.switch_arbitrate_rows(*args, **kw),
        rows_bytes(geo, replicas=replicas),
        lambda: ref.switch_arbitrate_rows_ref(*args, **kw))
    del args
    n, p = geo.n, geo.p
    qlen, rand, buf, head = vc_inputs(gen, replicas * n, p, V, Q)
    n_has = int((qlen > 0).any(dim=-1).sum())
    vc = (qlen, rand, buf, head)
    rec("vc_prearb", lambda: kernel.vc_prearb(*vc),
        vc_bytes(replicas * n * p, V, n_has), lambda: ref.vc_prearb_ref(*vc))
    del vc, qlen, rand, buf, head
    torch.cuda.empty_cache()
    return out


def device_ms(fn, name: str, iters: int = 100) -> Optional[float]:
    """Mean device time of the kernels whose name holds ``name``, per
    launch, over ``iters`` calls of ``fn`` under ``torch.profiler``; None
    if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name in e.key:
            total += getattr(e, "self_device_time_total", 0.0)
            count += e.count
    return total / count / 1e3 if count else None


def rows_label(lanes: int) -> str:
    return f"switch_arbitrate_rows ({lanes} lanes a row)"


def _launcher(fn, *args):
    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
    return launch


def time_point(geo: Geometry, gen: torch.Generator, iters: int = 200,
               plain_iters: int = 20) -> dict:
    """Per-launch times at ``geo`` (polarized, density 0.3):
    ``{label: {"ms", "device_ms", "plain_ms", "bound_ms", "bytes"}}``.
    ``ms`` is back to back by CUDA events (the C entry point on
    preallocated outputs); ``device_ms`` the profiler's kernel time."""
    lib = kernel._lib()
    stream = torch.cuda.current_stream().cuda_stream
    dev = gen.device
    out = {}

    def rec(label, launch, name, n_bytes, plain=None):
        r = dict(ms=cuda_ms(launch, iters=iters, warmup=20),
                 device_ms=device_ms(launch, name),
                 plain_ms=(cuda_ms(plain, iters=plain_iters, warmup=2)
                           if plain else None),
                 bound_ms=bound_ms(n_bytes) if n_bytes else None,
                 bytes=n_bytes)
        out[label] = r
        share = (f", {100 * r['bound_ms'] / r['device_ms']:.1f}% of the "
                 "bound" if r["bound_ms"] and r["device_ms"] else "")
        print(f"{geo.label} {label}: {r['ms'] * 1e3:.3f} us back to back, "
              f"{(r['device_ms'] or 0) * 1e3:.3f} us on the device "
              f"(profiler); bound "
              f"{(r['bound_ms'] or 0) * 1e3:.3f} us ({n_bytes} bytes){share}"
              + (f"; plain {r['plain_ms']:.6f} ms" if plain else ""),
              flush=True)

    # switch_arbitrate_rows, each number of lanes a row
    args, kw = rows_inputs(geo, gen, 0.3, "polarized")
    outs = [torch.empty(n, dtype=torch.int32, device=dev)
            for n in (geo.nr, geo.nr, geo.n * geo.p)]
    ptrs = [t.data_ptr() for t in (*args, kw["nic_first"], kw["dq_base"],
                                   *outs)]
    for m in kernel.ROWS_LANES:
        rec(rows_label(m),
            _launcher(lib.switch_arbitrate_rows_launch, *ptrs, geo.n, geo.p,
                      V, geo.d, PENALTY, OQ, 0, m, 1, geo.nr, stream),
            "switch_arbitrate_rows_kernel", rows_bytes(geo),
            lambda: ref.switch_arbitrate_rows_ref(*args, **kw))
    del args, outs, ptrs

    # the dense kernel at [N, P + d, P]
    r = geo.p + geo.d
    args = dense_inputs(gen, geo.n, r, geo.p)
    outs = [torch.empty(s, dtype=torch.int32, device=dev)
            for s in ((geo.n, r), (geo.n, r), (geo.n, geo.p))]
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    rec("switch_arbitrate (dense)",
        _launcher(lib.switch_arbitrate_launch, *ptrs, geo.n, r, geo.p,
                  PENALTY, stream),
        "switch_arbitrate_kernel", dense_bytes(geo.n, r, geo.p),
        lambda: ref.switch_arbitrate_ref(*args, penalty=PENALTY))
    del args, outs, ptrs

    # vc_prearb at [N, P, V], with and without the gather
    qlen, rand, buf, head = vc_inputs(gen, geo.n, geo.p, V, Q)
    rows = geo.n * geo.p
    outs = [torch.empty(rows, dtype=torch.int32, device=dev)
            for _ in range(3)]
    n_has = int((qlen > 0).any(dim=-1).sum())
    rec("vc_prearb", _launcher(
        lib.vc_prearb_launch, qlen.data_ptr(), rand.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), None, None, None, rows, V,
        0, stream), "vc_prearb_kernel", vc_bytes(rows, V),
        lambda: ref.vc_prearb_ref(qlen, rand))
    rec("vc_prearb + gather", _launcher(
        lib.vc_prearb_launch, qlen.data_ptr(), rand.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), buf.data_ptr(),
        head.data_ptr(), outs[2].data_ptr(), rows, V, Q, stream),
        "vc_prearb_kernel", vc_bytes(rows, V, n_has),
        lambda: ref.vc_prearb_ref(qlen, rand, buf, head))
    del qlen, rand, buf, head, outs

    # the floor of the timing itself: an empty kernel, one block and
    # vc_prearb's grid
    for blocks in (1, -(-rows // 256)):
        rec(f"empty kernel, {blocks} x 256 threads",
            _launcher(lib.empty_launch, blocks, 256, stream),
            "empty_kernel", 0)
    torch.cuda.empty_cache()
    return out


_COUNTED = ("LDG.E.128", "LDG", "LDGSTS", "SHFL", "LDS", "STS", "ATOMS",
            "STG")


def _function_label(head: str) -> Optional[str]:
    m = re.search(r"vc_prearb_kernelILb(\d)ELb(\d)E", head)
    if m:
        return (f"vc_prearb_kernel<{'int4' if m.group(1) == '1' else 'loop'}"
                f"{', gather' if m.group(2) == '1' else ''}>")
    m = re.search(r"switch_arbitrate_rows_kernelILi(\d+)ELb(\d)E", head)
    if m:
        return (f"switch_arbitrate_rows_kernel<{m.group(1)} lanes a row"
                f"{', replicas' if m.group(2) == '1' else ''}>")
    if "switch_arbitrate_kernel" in head:
        return "switch_arbitrate_kernel"
    return None


def sass_counts(path) -> Optional[dict]:
    """``{function: {"LDG.E.128": n, "LDG": n, "LDGSTS": n, "SHFL": n,
    "LDS": n, "STS": n, "ATOMS": n, "STG": n, "total": n}}`` for every
    arbitration kernel of the library at ``path`` (``cuobjdump -sass``;
    static counts; ``LDG`` counts every global load, ``LDG.E.128`` the
    16-byte ones); None without ``cuobjdump``."""
    sass = _sass(path)
    if sass is None:
        return None
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        label = _function_label(func.split("\n", 1)[0])
        if label is None:
            continue
        ops = _INSN.findall(func)
        base = collections.Counter(op.split(".")[0] for op in ops)
        rec = {name: base.get(name, 0) for name in _COUNTED}
        rec["LDG.E.128"] = sum(op.startswith("LDG.") and ".128" in op
                               for op in ops)
        rec["total"] = len(ops)
        out[label] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--watchdog", type=float, default=300.0,
                    help="seconds after which the bench dumps its stack "
                         "and exits (a kernel that hangs)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("switch_arb bench: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(opts.watchdog, exit=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip() or 'not available'}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all(["switch_arb"])["switch_arb"]
    print(f"built {built['path'].name} in {time.perf_counter() - t0:.2f} s")
    print(built["log"].strip())
    counts = sass_counts(built["path"])
    print(f"SASS: {json.dumps(counts)}", flush=True)
    dev = torch.device("cuda")
    geos = {label: geometry(label, dev) for label in GEOMETRIES}
    for g in geos.values():
        print(f"{g.label}: N={g.n} P={g.p} d={g.d} NR={g.nr}; "
              f"{int((g.nic_first >= 0).sum())} leaves; "
              f"{kernel._lib().switch_arbitrate_rows_smem(g.p, V, g.d)} "
              "bytes of shared memory a block")
    gen = torch.Generator(device=dev).manual_seed(18)
    try:
        errs = run_cases(geos, gen)
        for label in ("golden", "fig5"):
            for k, e in run_replica_cases(geos[label], gen).items():
                errs[k] = max(errs.get(k, 0), e)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(f"main path: {kernel.ROWS_MAIN_LANES} lanes a row")
    timed = {label: time_point(geos[label], gen)
             for label in ("fig5", "ft50", "df", "dfplus")}
    timed["fig5 R=4"] = time_replicas(geos["fig5"], gen)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"sass": counts, "max_abs_err": errs,
                      "main_lanes": kernel.ROWS_MAIN_LANES,
                      "timed": timed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
