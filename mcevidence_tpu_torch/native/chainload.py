"""ctypes bridge to the native C++ chain-file parser.

The Planck-grid workload parses tens of MB of whitespace-delimited text per
model (the reference leans on ``np.loadtxt``, its slowest host path —
MCEvidence.py:560-565).  ``libchainload.so`` (see ``chainload.cpp``) mmaps the
file and parses floats in parallel-friendly single-pass C++.  If the library
has not been built, ``load_table`` returns None and callers fall back to
pandas/numpy.

Build (done automatically on first import when a compiler is present):
    g++ -O3 -march=native -shared -fPIC chainload.cpp -o libchainload.so
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "chainload.cpp")
_LIB = os.path.join(_HERE, "libchainload.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # compiler missing / failed: fall back silently
        logger.debug("native chainload build failed: %s", e)
        return False


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.chainload_parse.restype = ctypes.c_longlong
            lib.chainload_parse.argtypes = [
                ctypes.c_char_p,                  # path
                ctypes.POINTER(ctypes.c_double),  # out buffer (may be NULL)
                ctypes.c_longlong,                # out capacity (elements)
                ctypes.POINTER(ctypes.c_longlong),  # out nrows
                ctypes.POINTER(ctypes.c_longlong),  # out ncols
            ]
            _lib = lib
        except OSError as e:
            logger.debug("native chainload load failed: %s", e)
            _build_failed = True
    return _lib


def load_table(path: str):
    """Parse a whitespace-delimited numeric table; None if native unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    nrows = ctypes.c_longlong(0)
    ncols = ctypes.c_longlong(0)
    # pass 1: probe dimensions (no buffer)
    rc = lib.chainload_parse(path.encode(), None, 0,
                             ctypes.byref(nrows), ctypes.byref(ncols))
    if rc < 0:
        return None
    probe_shape = (nrows.value, ncols.value)
    out = np.empty(probe_shape, dtype=np.float64)
    rc = lib.chainload_parse(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.size, ctypes.byref(nrows), ctypes.byref(ncols))
    if rc < 0:
        return None
    # The file can change between the probe and fill passes; a different
    # column count would make the row-major fill misaligned with `out`'s
    # stride, so reject anything but an exact shape match (the caller then
    # falls back to np.loadtxt on the current file contents).
    if (nrows.value, ncols.value) != probe_shape:
        logger.debug("native chainload: file %s changed between passes "
                     "(%s -> %s); falling back", path, probe_shape,
                     (nrows.value, ncols.value))
        return None
    return out
