"""Build ``mp_hsir_tpu_torch/csrc/*.cu`` into one shared library at first use
and load it with ctypes.

Each source compiles to an object with its own ``nvcc`` process, all started
together, then one ``nvcc -shared`` links them into
``build/kernels/mp_hsir_kernels_<hash>.so`` at the repository root. The hash
covers the sources, headers and flags, so an edited source rebuilds and an
unchanged tree reuses the library. Every C entry point takes plain pointers
(``c_void_p``) and the CUDA stream, launches on that stream and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return srcs, hdrs


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile and link the kernels if the library for this tree is absent;
    returns its path. Records seconds and the compiler's resource report in
    ``BUILD_INFO``."""
    srcs, hdrs = _sources()
    so = os.path.join(BUILD_DIR, f"mp_hsir_kernels_{_digest(srcs + hdrs)}.so")
    if os.path.exists(so):
        if BUILD_INFO.get("path") != so:  # keep the record of a build made by this process
            BUILD_INFO.update(path=so, seconds=0.0, cached=True)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fh:
        fh.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log[-8000:]}")
    tmp = so + f".{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp] + [o for _, o, _ in procs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, so)
    for _, obj, _ in procs:
        os.remove(obj)
    BUILD_INFO.update(path=so, seconds=time.perf_counter() - t0, cached=False, log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def entry(name: str, n_ptr: int, tail) -> "ctypes._CFuncPtr":
    """C entry point ``name`` with ``n_ptr`` pointer arguments, then the
    ctypes types in ``tail``, then the stream; returns a cudaError_t int."""
    fn = getattr(lib(), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()
