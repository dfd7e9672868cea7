"""Build and load the package's CUDA sources (csrc/*.cu).

Each source has a plain C interface: nvcc compiles it for sm_90a into a
shared library under ``_build/`` and ctypes loads it.  Every kernel module
(``ops.stream_trace``, ``ops.traverse``, ``ops.cluster_traverse``,
``ops.mxu_trace``, ``ops.brute_trace``, ``utils.rng``) builds its source
through ``build_library`` at its first launch, and the study tools build
their cut copies the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/*.cu at first use on a CUDA machine")


def build_library(src_path: str, extra=(), *, signatures: dict):
    """Compile one CUDA source with nvcc for sm_90a (the package's flags
    plus ``extra``) into _build/, named after the source and keyed by the
    hash of source and flags so that an edit rebuilds, and load it with
    ctypes, binding ``signatures`` ({function: argtypes}, each returning
    an int error code).  Returns (library, info); info holds the path, the
    seconds the build took, nvcc's log and the flags."""
    flags = [*NVCC_FLAGS, *extra]
    with open(src_path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src_path))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{key}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, src_path],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src_path}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, dict(path=so, seconds=time.perf_counter() - t0, log=log,
                     flags=flags)
