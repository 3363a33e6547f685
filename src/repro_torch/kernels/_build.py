"""Build the hand-written CUDA kernels at first use and bind them by ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/kernels/`` at the repository
root, named by a hash of every source in ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one is reused.  All missing
libraries build in parallel, one ``nvcc`` process each.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: shared memory one block may use on an H100 (bytes)
MAX_SHARED_BYTES = 232_448

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point and its argument types, per kernel library
SIGNATURES = {
    "bitserial_median": (
        "bitserial_median_launch",
        [_c_void_p] * 3 + [_c_int] * 6 + [_c_void_p] * 4),
    "clustered_decode": (
        "clustered_decode_launch",
        [_c_int] + [_c_void_p] * 10 + [_c_int] * 7 + [_c_float, _c_float,
                                                      _c_void_p]),
    "distance_argmin": (
        "distance_argmin_launch",
        [_c_int, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_void_p,
         _c_void_p, _c_void_p]),
    "flash_decode": (
        "flash_decode_launch",
        [_c_int] + [_c_void_p] * 3 + [_c_int] * 8 + [_c_float, _c_float]
        + [_c_void_p] * 3),
    "paged_clustered_decode": (
        "paged_clustered_decode_launch",
        [_c_int] + [_c_void_p] * 14 + [_c_int] * 7 + [_c_float, _c_float,
                                                      _c_void_p]),
}

#: further C functions that return a size: library, return type, arguments
QUERIES = {
    "bitserial_median_scratch_bytes": ("bitserial_median", ctypes.c_longlong,
                                       [_c_int] * 5),
    "distance_argmin_shared_bytes": ("distance_argmin", ctypes.c_longlong,
                                     []),
}

_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from csrc/ at first use and need the "
                           "CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is not built yet, all at once.
    Returns {name: seconds} for the libraries this call built."""
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f".{name}-{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    seconds = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise on a CUDA error."""
    fn = getattr(library(name), SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def query(fn_name: str, *args) -> int:
    """Call the C function ``fn_name`` of ``QUERIES`` and return its value."""
    lib_name, restype, argtypes = QUERIES[fn_name]
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn(*args)
