"""Build the package's CUDA sources with nvcc and load them with ctypes.

At first use of a CUDA tensor, every ``csrc/*.cu`` file is compiled into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC --resource-usage \
        -o csrc/_build/libknn_<hash>.so csrc/*.cu

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  The compiler writes to a
name of its own and ``os.replace`` publishes the result, so concurrent
processes never load a half-written library.  A missing ``nvcc`` or a failed
build raises with nvcc's output; nothing falls back.
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

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--resource-usage"]

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's build, None if cached
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libknn_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for them exists; returns its
    path.  The compiler's output (``--resource-usage``: registers, shared
    memory, spills per kernel) is kept in ``build_log``."""
    global build_seconds, build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}-{threading.get_ident()}.tmp"
    cmd = [find_nvcc()] + NVCC_FLAGS + ["-o", tmp] + _sources()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return out


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("knn_select_small_k", "knn_select_large_k"):
        fn = getattr(lib, name)
        # q, r, batch, q_rows, r_rows, nq, nr, nr_all, dp, k, self_mode,
        # out_d2, out_idx, stream, device
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
