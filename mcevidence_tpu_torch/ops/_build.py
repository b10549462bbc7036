"""Build the package's CUDA sources with nvcc and load them with ctypes.

At first use of a CUDA tensor, every ``csrc/*.cu`` file is compiled to an
object by its own nvcc process, all started together, and the objects are
linked into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
        -Xcompiler -fPIC --resource-usage -c -o <source>.o csrc/<source>.cu
    nvcc -shared -o csrc/_build/libknn_<hash>.so <source>.o ...

The file name carries a hash of the sources, the headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  The linker writes to a name of its own and ``os.replace`` publishes
the result, so concurrent processes never load a half-written library.  A
missing ``nvcc`` or a failed build raises with nvcc's output; nothing falls
back.
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
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--resource-usage"]
LINK_FLAGS = ["-shared"]
# C entry points, each with the argument list
# q, r, batch, q_rows, r_rows, nq, nr, nr_all, width, k, self_mode,
# out_d2, out_idx, stream, device
ENTRY_POINTS = ("knn_select_small_k", "knn_select_large_k",
                "knn_select_smalld_small_k", "knn_select_smalld_large_k")

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's build, None if cached
source_seconds: dict = {}  # nvcc wall time of each source in that build
build_log = ""            # nvcc's output (per-kernel registers, spills)


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


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libknn_{h.hexdigest()[:16]}.so")


def _compile(nvcc, src, tag):
    """One nvcc -c of ``src``; returns its object, command, output and
    seconds."""
    stem = os.path.splitext(os.path.basename(src))[0]
    obj = os.path.join(BUILD_DIR, f"{stem}.{tag}.o")
    cmd = [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return dict(src=stem, cmd=cmd, obj=obj, code=proc.returncode,
                output=proc.stdout + proc.stderr,
                seconds=time.perf_counter() - t0)


def build() -> str:
    """Compile the sources unless the library for them exists; returns its
    path.  The compiler's output (``--resource-usage``: registers, shared
    memory, spills per kernel) is kept in ``build_log``, each source's
    compile time in ``source_seconds``."""
    global build_seconds, build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp = f"{out}.{tag}.tmp"
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    sources = _sources()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        jobs = list(pool.map(lambda src: _compile(nvcc, src, tag), sources))
    try:
        for job in jobs:
            if job["code"] != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {job['code']}): "
                    f"{' '.join(job['cmd'])}\n{job['output']}")
        cmd = [nvcc] + LINK_FLAGS + ["-o", tmp] + [j["obj"] for j in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for path in [tmp] + [j["obj"] for j in jobs]:
            if os.path.exists(path):
                os.remove(path)
    build_seconds = time.perf_counter() - t0
    source_seconds.clear()
    source_seconds.update({j["src"]: j["seconds"] for j in jobs})
    build_log = "".join(j["output"] for j in jobs)
    return out


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, i32, i32, i32, i32,
                       ptr, ptr, ptr, i32]
        fn.restype = i32
    lib.knn_error_string.argtypes = [i32]
    lib.knn_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(build()))
    return _lib


def check(lib, code: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.knn_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
