"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``tensoir_tpu_torch/csrc/`` is compiled on first use,
one ``nvcc`` process per source, all started together, into a shared
library with a plain C interface under ``tensoir_tpu_torch/_build/``
(listed in ``.gitignore``). A library newer than its source is reused.
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
SOURCES = ("row_gather", "row_scatter_add")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "row_gather": ("row_gather_f32",
                   [_c_void_p, _c_void_p, _c_int, _c_void_p, _c_int64,
                    _c_int64, _c_void_p]),
    "row_scatter_add": ("row_scatter_add_f32",
                        [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int64,
                         _c_int64, _c_int64, _c_void_p]),
}

_loaded: Dict[str, Any] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> Dict[str, dict]:
    """Compile every stale library in parallel; returns per-source info:
    ``{"seconds": wall seconds of its nvcc (0 if reused), "log": ptxas -v}``.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info: Dict[str, dict] = {}
    for name in SOURCES:
        src, lib = CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
        if (not force and lib.exists()
                and lib.stat().st_mtime >= src.stat().st_mtime):
            info[name] = {"seconds": 0.0, "log": "reused"}
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def kernel(name: str):
    """The ctypes function of one kernel, building its library if needed."""
    fn = _loaded.get(name)
    if fn is None:
        lib = BUILD_DIR / f"lib{name}.so"
        src = CSRC / f"{name}.cu"
        if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
            build()
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
