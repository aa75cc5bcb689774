"""ctypes loader for the optional native C++ runtime (``native/``).

The port's own copy of :mod:`icp_tpu.utils.native` (which imports no JAX;
the port imports nothing of the JAX package).  It loads the same
``native/libicptpu.so``, building it from ``native/src/icptpu_native.cpp``
with ``g++`` on first use unless ``ICP_TPU_NO_NATIVE_BUILD`` is set, and
binds the bulk CSV parsing (one file, or many on threads) that
:mod:`icp_tpu_torch.io.scan_csv` uses: host work outside the tensor path.
Every caller has a pure-Python path, and the package works without the
library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libicptpu.so")


def build_native(verbose: bool = False) -> bool:
    """Compile the native library with g++ if the toolchain is available."""
    root = os.path.dirname(_lib_path())
    src = os.path.join(root, "src", "icptpu_native.cpp")
    if not os.path.exists(src):
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", src, "-o", _lib_path(),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 and verbose:
        print(res.stderr, file=sys.stderr)
    return res.returncode == 0


class NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.icptpu_parse_scan_csv.restype = ctypes.c_longlong
        lib.icptpu_parse_scan_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
        ]
        lib.icptpu_parse_scan_batch.restype = ctypes.c_int
        lib.icptpu_parse_scan_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
        ]

    def parse_scan_csv(self, path: str) -> np.ndarray | None:
        cap = 1 << 20
        buf = np.empty((cap, 2), dtype=np.float64)
        n = self._lib.icptpu_parse_scan_csv(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap
        )
        if n < 0 or n > cap:
            return None  # error or overflow: let the Python path report it
        return buf[:n].copy()

    def parse_scan_batch(self, paths: list[str], capacity: int):
        """Threaded bulk CSV load -> ((n, capacity, 2) f64, counts (n,) i64).

        Returns None if any file failed (fall back to the Python loader for
        a precise error)."""
        blob = b"\0".join(p.encode() for p in paths) + b"\0"
        n = len(paths)
        out = np.zeros((n, capacity, 2), dtype=np.float64)
        counts = np.empty(n, dtype=np.int64)
        rc = self._lib.icptpu_parse_scan_batch(
            blob, n, capacity,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
        if rc != 0:
            return None
        return out, counts


def native_lib() -> NativeLib | None:
    """Load (building on first use if possible) the native library."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    src = os.path.join(os.path.dirname(path), "src", "icptpu_native.cpp")
    stale = (
        os.path.exists(path)
        and os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(path)
    )
    if not os.path.exists(path) or stale:
        if os.environ.get("ICP_TPU_NO_NATIVE_BUILD"):
            return None  # never serve a stale or missing library
        if not build_native():
            return None
    try:
        _LIB = NativeLib(ctypes.CDLL(path))
    except OSError:
        _LIB = None
    return _LIB
