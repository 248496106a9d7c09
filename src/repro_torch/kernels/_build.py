"""Build the CUDA kernels at first use, then load them with ctypes.

Every ``kernels/<family>/csrc/<name>.cu`` compiles with ``nvcc`` into one
shared library ``build/kernels/<name>-<hash>.so`` at the root of the
checkout (the directory is git-ignored).  The sources expose plain C
entry points, so no PyTorch header is compiled and a build takes
seconds.  The hash covers every file in the source's ``csrc/`` (the
headers it includes too), the flags and the compiler path: unchanged
sources are loaded again without a rebuild.  Several sources
compile in parallel, one ``nvcc`` process each.

Nothing here runs at import: the CPU-only hosts that run the tests have
no ``nvcc``, and only a wrapper that is handed a CUDA tensor calls
:func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "sources", "build_all", "load"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; one load per process
_LOADED: dict = {}


def sources() -> dict:
    """``{name: path}`` of every CUDA source in the package."""
    return {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels are "
                           "built on a host with the CUDA toolkit")
    return nvcc


def _target(name: str, src: Path, nvcc: str, defines=()) -> Path:
    """The library built from ``src``: named by a hash of every file in
    its directory (name and bytes), the flags, the extra ``-D`` defines
    and the compiler path."""
    h = hashlib.sha256()
    for p in sorted(q for q in src.parent.rglob("*") if q.is_file()):
        h.update(str(p.relative_to(src.parent)).encode() + b"\0")
        h.update(p.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None, defines=()) -> dict:
    """Compile the named sources (default: all) that are not built yet,
    with ``-D`` flags ``defines`` (a build of its own; none for the
    kernels the port runs).

    Returns ``{name: {"path", "seconds", "log"}}``; ``log`` is nvcc's
    output (``-Xptxas -v`` register and shared-memory report), empty and
    ``seconds`` 0.0 for a library that was already built.  Raises with
    nvcc's output when a build fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    t0 = time.perf_counter()
    for name in names:
        target = _target(name, srcs[name], nvcc, defines)
        if target.exists():
            out[name] = {"path": target, "seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc))
    for name, target, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {srcs[name]}:\n{log}")
        os.replace(tmp, target)
        out[name] = {"path": target, "seconds": time.perf_counter() - t0,
                     "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
