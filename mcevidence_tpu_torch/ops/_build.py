"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file builds into a shared library of its own, with a
plain C interface, at the first call of one of its entry points:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
        -Xcompiler -fPIC --resource-usage -shared \
        -o csrc/_build/lib<source>_<hash>.so csrc/<source>.cu

so a path waits only for the nvcc runs of the sources whose kernels it
launches (the default engine: ``knn_select.cu``).  A library's name
carries a hash of its source, the headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded, while an edit to another source leaves it alone.  A build holds a
file lock beside its library (``<library>.lock``), so processes that start
together (the ranks of a ring) wait for one nvcc run instead of each
running their own; nvcc writes to a name of its own and ``os.replace``
publishes the result, so no process loads a half-written library.  A
missing ``nvcc`` or a failed build raises with nvcc's output; nothing
falls back, and a failed source leaves the others' libraries as they are.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--resource-usage"]
# C entry points, each with the argument list
# q, r, batch, q_rows, r_rows, nq, nr, nr_all, width, k, self_mode,
# out_d2, out_idx, stream, device
ENTRY_POINTS = ("knn_select_small_k", "knn_select_large_k",
                "knn_select_smalld_small_k", "knn_select_smalld_large_k")
# C entry points that take one more int after ``device``: ``low_bits`` of
# the packed selections, the ``cuts`` of the prologue study
ENTRY_POINTS_EXTRA = ("knn_select_packed_small_k",
                      "knn_select_packed_large_k", "knn_select_prologue")
# C entry points that take, after ``device``: low_bits, route, kp, warps,
# row0, row1 and a workspace pointer (csrc/knn_wide.cu)
ENTRY_POINTS_WIDE = ("knn_select_wide",)
# the C entry points that run the small-k body: each takes, last, an int64
# counter on the device that the body's screen adds its exact rechecks to,
# or null (csrc/knn_common.cuh)
ENTRY_POINTS_SMALL_K = ("knn_select_small_k", "knn_select_smalld_small_k",
                        "knn_select_packed_small_k", "knn_select_prologue")
# the source (csrc/<source>.cu) that defines each entry point
ENTRY_SOURCES = {
    "knn_select_small_k": "knn_select",
    "knn_select_large_k": "knn_select",
    "knn_select_smalld_small_k": "knn_smalld",
    "knn_select_smalld_large_k": "knn_smalld",
    "knn_select_packed_small_k": "knn_packed",
    "knn_select_packed_large_k": "knn_packed",
    "knn_select_prologue": "knn_packed",
    "knn_select_wide": "knn_wide",
}

_lock = threading.Lock()
_source_locks: dict = {}  # source -> the lock its first load holds
_libs: dict = {}          # source -> its loaded library
source_seconds: dict = {}  # nvcc wall time of each source this process built
build_logs: dict = {}      # nvcc's output of each (registers, spills)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda; raises."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def sources() -> list:
    """The names of the CUDA sources, ``csrc/<name>.cu``."""
    srcs = sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _source_path(source: str) -> str:
    path = os.path.join(CSRC, f"{source}.cu")
    if not os.path.isfile(path):
        raise ValueError(f"no CUDA source {path}")
    return path


def library_path(source: str) -> str:
    """Where the library of ``csrc/<source>.cu`` for the current source,
    headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
                 + [_source_path(source)]):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{source}_{h.hexdigest()[:16]}.so")


def build(source: str = None):
    """Build the library of ``csrc/<source>.cu`` unless it exists; returns
    its path.  With no ``source``, every source's, one nvcc process each,
    all started together; returns {source: path}.  nvcc's output
    (``--resource-usage``: registers, shared memory, spills per kernel) is
    kept in ``build_logs``, each source's compile time in
    ``source_seconds``.  A process that finds another one building a
    library waits on its lock, then takes the library it built."""
    if source is not None:
        return _build_one(source)
    srcs = sources()
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        jobs = {src: pool.submit(_build_one, src) for src in srcs}
    return {src: job.result() for src, job in jobs.items()}


def _build_one(source: str) -> str:
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    lock = f"{out}.lock"
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                _compile(source, out)
        finally:
            # a process still waiting on this file finds the library when it
            # gets the lock; one arriving later finds it before locking
            if os.path.exists(lock):
                os.remove(lock)
    return out


def _compile(source: str, out: str) -> None:
    tmp = f"{out}.{os.getpid()}-{threading.get_ident()}.tmp"
    cmd = ([find_nvcc()] + NVCC_FLAGS
           + ["-shared", "-o", tmp, _source_path(source)])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    source_seconds[source] = time.perf_counter() - t0
    build_logs[source] = proc.stdout + proc.stderr


def _declare(lib, source: str):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [ptr, ptr, i32, i32, i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr,
            ptr, i32]
    for names, argtypes in ((ENTRY_POINTS, args),
                            (ENTRY_POINTS_EXTRA, args + [i32]),
                            (ENTRY_POINTS_WIDE, args + [i32] * 6 + [ptr])):
        for name in names:
            if ENTRY_SOURCES[name] != source:
                continue
            fn = getattr(lib, name)
            fn.argtypes = argtypes + ([ptr] if name in ENTRY_POINTS_SMALL_K
                                      else [])
            fn.restype = i32
    lib.knn_error_string.argtypes = [i32]
    lib.knn_error_string.restype = ctypes.c_char_p
    return lib


def load(source: str):
    """The loaded library of ``csrc/<source>.cu``, built on first call."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        guard = _source_locks.setdefault(source, threading.Lock())
    with guard:
        if source not in _libs:
            _libs[source] = _declare(ctypes.CDLL(build(source)), source)
    return _libs[source]


def load_entry(entry: str):
    """The loaded library that defines the C entry point ``entry``."""
    return load(ENTRY_SOURCES[entry])


def loaded() -> list:
    """The sources whose libraries this process has loaded."""
    return sorted(_libs)


def check(lib, code: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.knn_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
