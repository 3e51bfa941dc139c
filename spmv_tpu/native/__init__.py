"""Native (C++) runtime component, loaded via ctypes.

The reference's I/O layer is native C/C++ (src/samples/mmio_highlevel.h);
this package holds the framework's native equivalent — a fast MatrixMarket
parser — compiled on first use with the system toolchain (g++; the ABI is
plain C + ctypes).

It degrades gracefully: if compilation fails, callers fall back to the
pure-Python parser (io/mmio.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["load_native", "native_available", "parse_mtx"]

_SRC = os.path.join(os.path.dirname(__file__), "spmv_native.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_spmv_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # build to a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except Exception:  # noqa: BLE001
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # <= so fresh checkouts (equal mtimes) rebuild for the local ISA —
        # a foreign -march=native binary would SIGILL, not fall back
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) <= os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        c = ctypes
        lib.mtx_parse.restype = c.c_void_p
        lib.mtx_parse.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
        lib.mtx_m.restype = c.c_int64
        lib.mtx_m.argtypes = [c.c_void_p]
        lib.mtx_n.restype = c.c_int64
        lib.mtx_n.argtypes = [c.c_void_p]
        lib.mtx_nnz.restype = c.c_int64
        lib.mtx_nnz.argtypes = [c.c_void_p]
        lib.mtx_copy.restype = None
        lib.mtx_copy.argtypes = [c.c_void_p] + [np.ctypeslib.ndpointer(d)
                                                for d in (np.int32, np.int32,
                                                          np.float64)]
        lib.mtx_free.restype = None
        lib.mtx_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def parse_mtx(path: str):
    """(m, n, rows, cols, vals) COO with symmetry expanded, or None."""
    lib = load_native()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    h = lib.mtx_parse(path.encode(), ctypes.byref(err))
    if not h:
        return None
    try:
        m, n, nnz = lib.mtx_m(h), lib.mtx_n(h), lib.mtx_nnz(h)
        rows = np.empty(nnz, np.int32)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float64)
        lib.mtx_copy(h, rows, cols, vals)
        return int(m), int(n), rows, cols, vals
    finally:
        lib.mtx_free(h)
