"""ctypes bridge to the native C++ chain-file parser.

The Planck-grid workload parses tens of MB of whitespace-delimited text per
model (the reference leans on ``np.loadtxt``, its slowest host path —
MCEvidence.py:560-565).  ``libchainload.so`` (see ``chainload.cpp``) maps the
file once, takes the table's shape from a newline count and the first data
line, and converts each number once, CosmoMC's ``%16.7E`` fields by a
fixed-layout decoder and any other token by the general one.  A file of
more than ``SLICE_BYTES`` is decoded in row slices, one thread a slice
(``_slices`` says how many).  If the library has not been built,
``load_table`` returns None and callers fall back to pandas/numpy.

Build (done automatically on first use when a compiler is present):
    g++ -O3 -shared -fPIC -std=c++17 -pthread chainload.cpp -o libchainload.so
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "chainload.cpp")
_LIB = os.path.join(_HERE, "libchainload.so")
_lock = threading.Lock()
_lib = None
_build_failed = False

# A slice holds at least this much text, so a short chain is one slice.
SLICE_BYTES = 2 << 20
# parse_table calls in flight in this process; they share its CPUs
_in_flight = 0
_in_flight_lock = threading.Lock()


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    # built under a name of its own, then renamed: processes that import
    # this module at once never load another's half-written library
    tmp = f"{_LIB}.{os.getpid()}-{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # compiler missing / failed: fall back silently
        logger.debug("native chainload build failed: %s", e)
        if os.path.exists(tmp):
            os.remove(tmp)
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
            lib.chainload_open.restype = ctypes.c_void_p
            lib.chainload_open.argtypes = [
                ctypes.c_char_p,                    # path
                ctypes.c_longlong,                  # slices
                ctypes.POINTER(ctypes.c_longlong),  # out row bound
                ctypes.POINTER(ctypes.c_longlong),  # out ncols
            ]
            lib.chainload_fill.restype = ctypes.c_longlong
            lib.chainload_fill.argtypes = [
                ctypes.c_void_p,                    # handle
                ctypes.POINTER(ctypes.c_double),    # out buffer
                ctypes.c_longlong,                  # out capacity (elements)
                ctypes.POINTER(ctypes.c_longlong),  # out nrows
                ctypes.POINTER(ctypes.c_longlong),  # out fixed-layout fields
            ]
            lib.chainload_close.restype = None
            lib.chainload_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError as e:
            logger.debug("native chainload load failed: %s", e)
            _build_failed = True
    return _lib


def _slices(size: int, in_flight: int) -> int:
    """The slices a file of ``size`` bytes is decoded in: one a
    ``SLICE_BYTES`` of text, and no more than the CPUs this process may use,
    less one for the caller's other work, shared among the ``in_flight``
    parses."""
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)
    return max(1, min(-(-size // SLICE_BYTES), (cpus - 1) // in_flight))


def parse_table(path: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """Parse a whitespace-delimited numeric table in one pass over the file:
    (the table, how many of its fields the fixed-layout decoder took, the
    slices it was decoded in), or None where the native parser is
    unavailable or rejects the file."""
    global _in_flight
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    with _in_flight_lock:
        _in_flight += 1
        in_flight = _in_flight
    try:
        return _parse(path, _slices(size, in_flight))
    finally:
        with _in_flight_lock:
            _in_flight -= 1


def _parse(path: str,
           slices: int) -> Optional[Tuple[np.ndarray, int, int]]:
    """``parse_table`` in ``slices`` slices."""
    lib = _get_lib()
    if lib is None:
        return None
    nrows = ctypes.c_longlong(0)
    ncols = ctypes.c_longlong(0)
    handle = lib.chainload_open(os.fsencode(path), slices,
                                ctypes.byref(nrows), ctypes.byref(ncols))
    if not handle:
        return None
    nfixed = ctypes.c_longlong(0)
    try:
        # rows bounded by the newline count; trimmed to those written
        out = np.empty((nrows.value, ncols.value), dtype=np.float64)
        rc = lib.chainload_fill(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.size, ctypes.byref(nrows), ctypes.byref(nfixed))
    finally:
        lib.chainload_close(handle)
    if rc < 0:
        return None
    return out[:nrows.value], nfixed.value, slices


def load_table(path: str) -> Optional[np.ndarray]:
    """Parse a whitespace-delimited numeric table; None if native unavailable."""
    got = parse_table(path)
    return None if got is None else got[0]
