"""The compiled host helper of the AMG setup (``csrc/hostlib.cpp``).

Built with the host C++ compiler on first use, into ``build/host`` of the
checkout (never at import), and loaded with ctypes.  A failed build
raises: there is no quiet fall back to the numpy loop
(``linear/amg.aggregate_plain``, the plain version kept beside it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "hostlib.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")
LIBRARY = os.path.join(BUILD_DIR, "libfvmhost.so")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def build():
    """Compile (when the library is missing or older than its source) and
    load the helper; returns the ctypes library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (c++ or g++) to "
                                   f"build {SOURCE}")
            # build under a private name, then rename: a process loading
            # the library never sees another's half-written file
            tmp = f"{LIBRARY}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(LIBRARY)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fvm_aggregate.restype = ctypes.c_int64
        lib.fvm_aggregate.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                      ctypes.POINTER(ctypes.c_uint8), i64p]
        _lib = lib
        return lib


def aggregate(cols: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Greedy aggregation of the host (n, K) row graph: compressed
    aggregate id per row (``fvm_aggregate``)."""
    lib = build()
    n, K = cols.shape
    c = np.ascontiguousarray(cols, dtype=np.int64)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(n, dtype=np.int64)
    lib.fvm_aggregate(n, K, c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
