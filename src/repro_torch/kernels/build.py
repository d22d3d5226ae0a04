"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in `repro_torch/csrc/` has a plain C interface and compiles
with `nvcc` for `sm_90a` into its own shared library under
`build/kernels/` at the repository root (listed in `.gitignore`). The
library's name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads from disk. Nothing compiles at
import: the CPU tests import every module on a machine without `nvcc`.
`build()` starts one `nvcc` for each source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("relax_sweep", "minplus", "edge_relax", "embed_bag",
           "seed_match")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], ctypes._CFuncPtr] = {}
#: nvcc's output (ptxas registers / shared memory) of each fresh build.
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every named source that is not built yet, all at once.

    Returns the wall seconds spent; raises with nvcc's output if any
    compile fails.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).is_file()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    every other source of SOURCES not built yet, all at once: a program's
    first launches then wait for one build, not one each."""
    lib = _libs.get(name)
    if lib is None:
        build(SOURCES if name in SOURCES else (name,))
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C function `symbol` of `csrc/<name>.cu`, typed to return int; typed
    once and kept, since the kernels' wrappers call it on every launch.

    Pointers and the stream go as `ctypes.c_void_p`: untyped, ctypes would
    pass them as 32-bit ints and cut them.
    """
    fn = _funcs.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[name, symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`, which launch geometries take;
    read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count
