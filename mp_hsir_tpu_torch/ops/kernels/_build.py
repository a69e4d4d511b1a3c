"""Build ``mp_hsir_tpu_torch/csrc/*.cu`` into one shared library at first use
and load it with ctypes.

Each source compiles to an object with its own ``nvcc`` process, all started
together, then one ``nvcc -shared`` links them into
``build/kernels/mp_hsir_kernels_<hash>.so`` at the repository root. The hash
covers the sources, headers and flags, so an edited source rebuilds and an
unchanged tree reuses the library. Every C entry point takes plain pointers
(``c_void_p``) and the CUDA stream, launches on that stream and returns
``cudaGetLastError()``; :func:`check` raises when it is not 0. Each kernel
also exports ``mp_<kernel>_smem``, the shared memory per block of its plan at
a shape; :func:`check_plan` holds that against the device's opt-in limit
before the launch. The kernels that stage their input in channel chunks
export ``mp_<kernel>_chunk`` too (:func:`chunk`), and take the chunk as an
argument.
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
from functools import lru_cache

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
    returns its path. Records seconds (in all, and when each source's nvcc
    ended) and the compiler's resource report in ``BUILD_INFO``."""
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
    outs = {}

    def wait(src, p):  # one waiter a source: each records when its own nvcc ended
        out, _ = p.communicate()
        outs[src] = (out, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(src, p)) for src, _, p in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], []
    for src, obj, p in procs:
        logs.append(f"== {os.path.basename(src)}\n{outs[src][0]}")
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
    BUILD_INFO.update(path=so, seconds=time.perf_counter() - t0, cached=False, log=log,
                      seconds_by_source={os.path.basename(src): round(outs[src][1], 1)
                                         for src, _, _ in procs})
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


@lru_cache(maxsize=None)
def smem_limit() -> int:
    """Shared memory a block may opt into on the current device, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``; 232,448 on an H100)."""
    fn = lib().mp_smem_optin
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


@lru_cache(maxsize=None)
def chunk(entry: str, *shape: int) -> int:
    """The channel chunk a staged kernel launches with at ``shape``: the
    return of ``entry``, an ``mp_<kernel>_chunk`` function of ints (C, the
    whole input resident, where that plan fits the device; else 64). Asked
    once per shape; the wrapper passes it to every launch."""
    fn = getattr(lib(), entry)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(shape), ctypes.c_int
    return int(fn(*shape))


@lru_cache(maxsize=None)
def plan_bytes(entry: str, *shape: int) -> int:
    """Shared memory per block (dynamic plus static, bytes) of the plan the C
    side launches with at ``shape`` (the staged kernels' shapes end with the
    channel chunk): the return of ``entry``, an ``mp_<kernel>_smem`` function
    of ints."""
    fn = getattr(lib(), entry)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(shape), ctypes.c_longlong
    return int(fn(*shape))


def check_plan(kernel: str, entry: str, what: str, *shape: int) -> int:
    """Raise ValueError before a launch whose shared-memory plan exceeds the
    device's opt-in limit (the launch would fail with a bare cudaError);
    ``what`` names the shape. Returns the plan's bytes."""
    n, limit = plan_bytes(entry, *shape), smem_limit()
    if n > limit:
        raise ValueError(f"{kernel} at {what}: its shared-memory plan needs {n} bytes per "
                         f"block, over this device's opt-in limit of {limit} bytes")
    return n
