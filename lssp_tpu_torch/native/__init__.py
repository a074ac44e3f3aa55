"""Native C++ host kernels for the ILU setup (level sets, ILU(0), the ILU(k)
symbolic phase, ILUT), loaded with ctypes.

``src/ilu.cpp`` is the JAX package's source, built here the same way
(``g++ -O3 -march=native -ffp-contract=off``) so the factors are
bit-identical.  The library is built on first use into
``lssp_tpu_torch/_build/``, and rebuilt when the source is newer.  There is
no pure-Python fallback: a missing compiler raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ilu.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "liblssp_torch_native.so")

_lock = threading.Lock()
_lib = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
           "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise RuntimeError(f"building the native ILU library failed: {e}\n{detail}") from e
    os.replace(tmp, _LIB_PATH)       # atomic: a concurrent loader never sees half a file


def load():
    """The ctypes library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.lssp_levels.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_int, _i64p]
        lib.lssp_levels.restype = None
        lib.lssp_ilu0.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double]
        lib.lssp_ilu0.restype = None
        lib.lssp_iluk_symbolic.argtypes = [_i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_iluk_symbolic.restype = ctypes.c_void_p
        lib.lssp_ilut.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64, ctypes.c_double,
                                  ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.lssp_ilut.restype = ctypes.c_void_p
        lib.lssp_pattern_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p, ctypes.c_void_p]
        lib.lssp_pattern_fetch.restype = None
        lib.lssp_pattern_free.argtypes = [ctypes.c_void_p]
        lib.lssp_pattern_free.restype = None
        _lib = lib
        return _lib


def levels(indptr: np.ndarray, indices: np.ndarray, n: int, lower: bool) -> np.ndarray:
    """Longest-dependency-chain level of every row of a strict triangular
    factor."""
    out = np.zeros(n, dtype=np.int64)
    load().lssp_levels(np.ascontiguousarray(indptr, np.int64),
                       np.ascontiguousarray(indices, np.int64), n, 1 if lower else 0, out)
    return out


def ilu0(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
         ztol: float, zval: float) -> np.ndarray:
    """IKJ ILU(0) on a fixed sorted pattern; returns the factored values."""
    data = np.ascontiguousarray(data, np.float64).copy()
    load().lssp_ilu0(np.ascontiguousarray(indptr, np.int64),
                     np.ascontiguousarray(indices, np.int64),
                     data, len(indptr) - 1, ztol, zval)
    return data


def _fetch(lib, handle, n, nnz, with_data):
    new_ip = np.zeros(n + 1, dtype=np.int64)
    new_idx = np.zeros(nnz, dtype=np.int64)
    new_dat = np.zeros(nnz, dtype=np.float64) if with_data else None
    lib.lssp_pattern_fetch(handle, new_ip, new_idx,
                           new_dat.ctypes.data_as(ctypes.c_void_p) if with_data else None)
    lib.lssp_pattern_free(handle)
    return new_ip, new_idx, new_dat


def iluk_symbolic(indptr: np.ndarray, indices: np.ndarray, n: int, level: int):
    """Level-of-fill pattern: returns (indptr, indices), int64."""
    lib = load()
    nnz = ctypes.c_int64(0)
    h = lib.lssp_iluk_symbolic(np.ascontiguousarray(indptr, np.int64),
                               np.ascontiguousarray(indices, np.int64),
                               n, level, ctypes.byref(nnz))
    ip, idx, _ = _fetch(lib, h, n, nnz.value, with_data=False)
    return ip, idx


def ilut(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n: int,
         tol: float, p: int, ztol: float, zval: float):
    """Dual-threshold ILUT: returns the combined factor (indptr, indices,
    data)."""
    lib = load()
    nnz = ctypes.c_int64(0)
    h = lib.lssp_ilut(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      n, tol, p, ztol, zval, ctypes.byref(nnz))
    return _fetch(lib, h, n, nnz.value, with_data=True)
