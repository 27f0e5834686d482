"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so``, the hash taken over the source and the
flags, so an edited source builds anew and an unchanged one is reused.
Nothing is compiled when a module is imported: the first launch of a kernel
builds it, or a caller builds them all at once with :func:`build_all`, which
starts one nvcc per source and waits for all of them. ``build_s`` counts
the seconds the process has spent in both: building, and loading the built
libraries.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: host seconds this process spent building (:func:`build_all`) and loading
#: (:func:`load`) the kernel libraries
build_s = 0.0


def sources() -> Dict[str, Path]:
    """Kernel name -> its .cu source, for every source in csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_all(names: Iterable[str] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together.

    Returns name -> {"seconds": wall time of its nvcc (0.0 if it was
    already built), "log": nvcc's output (ptxas register and shared-memory
    report)}. Raises with nvcc's output if any build fails.
    """
    global build_s
    t_start = time.perf_counter()
    try:
        return _build(list(sources()) if names is None else list(names))
    finally:
        build_s += time.perf_counter() - t_start


def _build(names) -> Dict[str, dict]:
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    failed = []
    for name, (t0, tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built first if needed)."""
    global build_s
    path = library_path(name)
    if not path.exists():
        build_all([name])
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    build_s += time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def function(name: str, symbol: str, argtypes: tuple):
    """C function ``symbol`` of kernel ``name``, with its argument types
    declared and an int (cudaError) result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
