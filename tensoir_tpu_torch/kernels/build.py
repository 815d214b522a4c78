"""Build the port's native libraries and load them with ctypes.

Each source under ``tensoir_tpu_torch/csrc/`` is compiled on first use,
one compiler process per source, all started together, into a shared
library with a plain C interface under ``tensoir_tpu_torch/_build/``
(listed in ``.gitignore``). A library newer than its source is reused.
The CUDA kernels (``*.cu``) go through ``nvcc`` for sm_90a; the host
iso-surface extractor (``mesh_extract.cpp``) through ``g++`` with the JAX
package's flags (``-O3 -march=native``: g++ then contracts into FMAs
where the JAX package's build does, so both give the same vertices).
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_SOURCES = ("row_gather", "row_scatter_add", "line_taps")
HOST_SOURCES = ("mesh_extract",)
SOURCES = CUDA_SOURCES + HOST_SOURCES
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_c_void_p, _c_int, _c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GATHER_ARGS = [_c_void_p, _c_void_p, _c_int, _c_void_p, _c_int64, _c_int64,
                _c_void_p]
# exported C function -> (source it lives in, ctypes argument types)
_SIGNATURES = {
    "row_gather_f32": ("row_gather", _GATHER_ARGS),
    "row_gather_b16": ("row_gather", _GATHER_ARGS),
    "row_scatter_add_f32": ("row_scatter_add",
                            [_c_void_p, _c_int, _c_void_p, _c_void_p,
                             _c_int64, _c_int64, _c_int64, _c_void_p]),
    # int line_taps_f32(line0, line1, line2, ld0, ld1, ld2, d0, d1, d2,
    #                   axis0, axis1, axis2, k, extrapolate, coords, out,
    #                   n, r, stream)
    "line_taps_f32": ("line_taps",
                      [_c_void_p] * 3 + [_c_int64] * 6 + [_c_int] * 5
                      + [_c_void_p, _c_void_p, _c_int64, _c_int64,
                         _c_void_p]),
    # int mesh_extract(grid, nx, ny, nz, level, origin, spacing,
    #                  &verts, &n_verts, &faces, &n_faces)
    "mesh_extract": ("mesh_extract",
                     [_c_void_p, _c_int64, _c_int64, _c_int64,
                      ctypes.c_float, _c_void_p, _c_void_p, _c_void_p,
                      _c_void_p, _c_void_p, _c_void_p]),
    "mesh_free": ("mesh_extract", [_c_void_p]),
}
_RESTYPES = {"mesh_free": None}

_loaded: Dict[str, Any] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _command(name: str, out: Path) -> list:
    src = str(_source(name))
    if name in HOST_SOURCES:
        return [GXX, *GXX_FLAGS, src, "-o", str(out)]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), src]


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    return (not lib.exists()
            or lib.stat().st_mtime < _source(name).stat().st_mtime)


def build(force: bool = False, names=SOURCES) -> Dict[str, dict]:
    """Compile every stale library of ``names`` in parallel; returns
    per-source info: ``{"seconds": wall seconds of its compiler (0 if
    reused), "log": the compiler's output (ptxas -v for a kernel)}``.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info: Dict[str, dict] = {}
    for name in names:
        if not force and not _stale(name):
            info[name] = {"seconds": 0.0, "log": "reused"}
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, BUILD_DIR / f"lib{name}.so", time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return info


def kernel(symbol: str):
    """The ctypes function ``symbol`` of one library, building the
    library if it is missing or older than its source. A stale CUDA
    library is built together with every other stale CUDA library, in
    parallel: a process that needs one kernel soon needs the others, and
    one build at a time would add each compiler's seconds to its set-up."""
    fn = _loaded.get(symbol)
    if fn is None:
        name, argtypes = _SIGNATURES[symbol]
        if _stale(name):
            build(names=tuple(n for n in CUDA_SOURCES if _stale(n))
                  if name in CUDA_SOURCES else (name,))
        fn = getattr(ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so")), symbol)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(symbol, ctypes.c_int)
        _loaded[symbol] = fn
    return fn
