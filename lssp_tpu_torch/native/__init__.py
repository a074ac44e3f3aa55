"""Native C++ host kernels, loaded with ctypes: the ILU setup (level sets,
ILU(0), the ILU(k) symbolic phase, ILUT; ``src/ilu.cpp``), the AMG setup
(the fused Galerkin product and Gershgorin bound, ``src/rap.cpp``; the
lumping filters, ``src/amgfilter.cpp``; the greedy strength aggregation,
``src/aggregate.cpp``) and the direct solvers (the minimum-degree ordering,
``src/amd.cpp``; the Gilbert–Peierls LU, ``src/splu.cpp``; the supernodal
multifrontal LU, ``src/mf.cpp``, which takes its BLAS / LAPACK from scipy's
``cython_blas`` / ``cython_lapack`` capsules; the George–Heath sparse QR,
``src/spqr.cpp``).

The sources are the JAX package's, built here the same way (``g++ -O3
-march=native -ffp-contract=off``) so the outputs are bit-identical.  The
library is built on first use into ``lssp_tpu_torch/_build/``, and rebuilt
when a source is newer.  The ILU wrappers have no pure-Python fallback: a
missing compiler raises.  The AMG setup asks ``available()`` first and
otherwise takes its numpy oracles, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "src", f)
         for f in ("ilu.cpp", "rap.cpp", "amgfilter.cpp", "aggregate.cpp", "amd.cpp",
                   "splu.cpp", "mf.cpp", "spqr.cpp")]
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
           "-shared", "-fPIC", *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise RuntimeError(f"building the native host library failed: {e}\n{detail}") from e
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
                or any(os.path.getmtime(_LIB_PATH) < os.path.getmtime(s) for s in _SRCS)):
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
        _declare_amg(lib)
        _declare_direct(lib)
        _lib = lib
        return _lib


def _declare_amg(lib) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for suf, ptr in (("_i32", i32p), ("_i64", _i64p)):
        fl = getattr(lib, "lssp_filter_lumped" + suf)
        fl.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, ctypes.c_double, ptr, ptr, _f64p]
        fl.restype = ctypes.c_int64
        lp = getattr(lib, "lssp_lump_pattern" + suf)
        lp.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ptr, ptr, _f64p]
        lp.restype = ctypes.c_int64
        gs = getattr(lib, "lssp_gersh" + suf)
        gs.argtypes = [ptr, _f64p, _f64p, ctypes.c_long]
        gs.restype = ctypes.c_double
        rp = getattr(lib, "lssp_rap" + suf)
        rp.argtypes = [ptr, ptr, _f64p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ptr, ctypes.c_long, ptr, ptr, _f64p, ctypes.c_long]
        rp.restype = ctypes.c_long
        do = getattr(lib, "lssp_dia_offsets" + suf)
        do.argtypes = [ptr, ptr, ctypes.c_int64, ctypes.c_int64, _i64p]
        do.restype = ctypes.c_int64
        for fsuf, fptr in (("_f32", np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")),
                           ("_f64", _f64p)):
            df = getattr(lib, "lssp_dia_fill" + fsuf + suf)
            df.argtypes = [ptr, ptr, _f64p, ctypes.c_int64, _i64p, ctypes.c_int64, fptr]
            df.restype = None
    lib.lssp_greedy_aggregate.argtypes = [
        _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), _i64p]
    lib.lssp_greedy_aggregate.restype = None


def _declare_direct(lib) -> None:
    lib.lssp_amd_order.argtypes = [_i64p, _i64p, ctypes.c_int64, _i64p]
    lib.lssp_amd_order.restype = None
    lib.lssp_splu.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64, ctypes.c_double,
                              ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
    lib.lssp_splu.restype = ctypes.c_void_p
    lib.lssp_splu_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.lssp_splu_sizes.restype = None
    lib.lssp_splu_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p, _f64p, _i64p, _i64p,
                                    _f64p, _i64p]
    lib.lssp_splu_fetch.restype = None
    lib.lssp_splu_free.argtypes = [ctypes.c_void_p]
    lib.lssp_splu_free.restype = None
    lib.lssp_spqr.argtypes = [_i64p, _i64p, _f64p, ctypes.c_int64, ctypes.c_int64, _f64p,
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                              ctypes.POINTER(ctypes.c_int64)]
    lib.lssp_spqr.restype = ctypes.c_void_p
    lib.lssp_spqr_fetch.argtypes = [ctypes.c_void_p, _i64p, _i64p, _f64p, _f64p]
    lib.lssp_spqr_fetch.restype = None
    lib.lssp_spqr_free.argtypes = [ctypes.c_void_p]
    lib.lssp_spqr_free.restype = None
    lib.lssp_mf_symbolic.argtypes = [_i64p, _i64p, ctypes.c_long, _i64p, _i64p, _i64p,
                                     _i64p, _i64p, ctypes.c_long]
    lib.lssp_mf_symbolic.restype = ctypes.c_long
    lib.lssp_mf_numeric.argtypes = [
        _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, ctypes.c_long,
        _i64p, _i64p, _i64p, _i64p, ctypes.c_long, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        _i64p, _i64p, _f64p, ctypes.c_long, _i64p, _i64p, _f64p, ctypes.c_long, _i64p]
    lib.lssp_mf_numeric.restype = ctypes.c_long


_available = None


def available() -> bool:
    """Whether the library builds and loads here.  The AMG setup takes its
    native paths only then, and its numpy oracles otherwise (the JAX
    package's rule)."""
    global _available
    if _available is None:
        try:
            load()
            _available = True
        except (RuntimeError, OSError):
            _available = False
    return _available


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


def _isuf(indptr):
    return "_i32" if indptr.dtype == np.int32 else "_i64"


def _lumped_call(name, indptr, indices, data, n, *args):
    """Shared shape of the two lumping filters: outputs of the input's
    index type, ``None`` when some lumped row has no kept diagonal."""
    if indptr.dtype != indices.dtype:
        indices = indices.astype(indptr.dtype, copy=False)
    nnz = len(indices)
    oip = np.empty(n + 1, dtype=indptr.dtype)
    oix = np.empty(nnz, dtype=indptr.dtype)
    oax = np.empty(nnz, dtype=np.float64)
    fn = getattr(load(), name + _isuf(indptr))
    out = fn(indptr, indices, np.ascontiguousarray(data, np.float64), n, *args, oip, oix, oax)
    if out < 0:
        return None
    return oip, oix[:out], oax[:out]


def dia_convert(indptr, indices, data, n: int, max_diags: int, out_dtype):
    """The fused CSR→DIA of JAX's native library (oracle:
    ``sparse/convert.py: csr_to_dia``): (offsets int64 (ndiag,), data
    (ndiag, n) of ``out_dtype``, float32 or float64), or None when the
    matrix has more than ``max_diags`` distinct diagonals."""
    lib = load()
    indptr = np.ascontiguousarray(indptr)
    if indptr.dtype not in (np.int32, np.int64):
        indptr = indptr.astype(np.int64)
    indices = np.ascontiguousarray(indices, dtype=indptr.dtype)
    suf = _isuf(indptr)
    offs = np.empty(max_diags, dtype=np.int64)
    ndiag = getattr(lib, "lssp_dia_offsets" + suf)(indptr, indices, n, max_diags, offs)
    if ndiag < 0:
        return None
    offs = offs[:ndiag].copy()
    out_dtype = np.dtype(out_dtype)
    out = np.empty((ndiag, n), dtype=out_dtype)
    fsuf = "_f32" if out_dtype == np.float32 else "_f64"
    getattr(lib, "lssp_dia_fill" + fsuf + suf)(indptr, indices,
                                                np.ascontiguousarray(data, np.float64), n,
                                                offs, ndiag, out)
    return offs, out


def filter_lumped(indptr, indices, data, n: int, tol: float):
    """Drop |a_ij| < tol·√(|a_ii|·|a_jj|) and lump the dropped mass onto the
    diagonal (oracle: ``amg/sa.py: _filter_lumped``).  Returns (indptr,
    indices, data) of the filtered CSR, or None when some lumped row has no
    kept structural diagonal (the caller takes the oracle then)."""
    return _lumped_call("lssp_filter_lumped", indptr, indices, data, n, tol)


def lump_pattern(indptr, indices, data, n: int, gx: int, ry: int, rx: int):
    """Lump everything outside the (2ry+1)×(2rx+1) grid stencil onto the
    diagonal (oracle: ``amg/sa.py: _lump_to_pattern``); the return contract
    of ``filter_lumped``."""
    return _lumped_call("lssp_lump_pattern", indptr, indices, data, n, gx, ry, rx)


def gersh(indptr, data, dinv, n: int):
    """Gershgorin bound max_i |dinv_i|·Σ_j |a_ij| (oracle:
    ``amg/setup.py: lambda_gershgorin``); None for non-float64 data."""
    if data.dtype != np.float64:
        return None
    fn = getattr(load(), "lssp_gersh" + _isuf(indptr))
    return float(fn(indptr, np.ascontiguousarray(data, np.float64),
                    np.ascontiguousarray(dinv, np.float64), n))


def rap(A, B, p0_cols, nc: int):
    """Galerkin product Ac = (B·P0)ᵀ·A·(B·P0), P0 the aggregation map
    ``p0_cols`` (the coarse column of each row), ``B`` a scipy CSR or None
    (P = P0).  Oracle: the scipy triple product in ``amg/sa.py:
    sa_host_levels``.  Returns a scipy CSR, or None for non-float64 A."""
    import scipy.sparse as sp
    A = A.tocsr()
    if A.data.dtype != np.float64:
        return None
    n = A.shape[0]
    ip = A.indptr
    ix = A.indices.astype(ip.dtype, copy=False)
    p0 = np.ascontiguousarray(p0_cols, dtype=ip.dtype)
    fn = getattr(load(), "lssp_rap" + _isuf(ip))
    if B is not None:
        B = B.tocsr()
        keep = (np.ascontiguousarray(B.indptr, dtype=ip.dtype),
                np.ascontiguousarray(B.indices, dtype=ip.dtype),
                np.ascontiguousarray(B.data, dtype=np.float64))
        bargs = tuple(a.ctypes.data for a in keep)
    else:
        keep, bargs = (), (None, None, None)
    # a modest first cap; the kernel reports a usable size on overflow.
    # The used slices are copied out so the cap-sized buffers do not stay
    # alive as bases of each level's arrays
    cap = int(A.nnz * 0.6 + 16 * max(nc, 1))
    for _ in range(4):
        oip = np.empty(nc + 1, dtype=ip.dtype)
        oix = np.empty(cap, dtype=ip.dtype)
        oax = np.empty(cap, dtype=np.float64)
        out = fn(ip, ix, np.ascontiguousarray(A.data, np.float64), n, *bargs, p0, nc,
                 oip, oix, oax, cap)
        if out >= 0:
            del keep
            return sp.csr_matrix((oax[:out].copy(), oix[:out].copy(), oip), shape=(nc, nc))
        cap = int(-out)
    return None


def greedy_aggregate(A, T, g: int, theta: float, virt: np.ndarray) -> np.ndarray:
    """Raw greedy strength-BFS aggregate ids over the symmetrised strength
    graph of the scipy CSR ``A`` (``T`` its transpose, CSR); the oracle is
    ``amg/aggregate.py: _bfs_ids`` (the exactness fix-up is shared)."""
    n = A.shape[0]
    ids = np.empty(n, dtype=np.int64)
    load().lssp_greedy_aggregate(
        np.ascontiguousarray(A.indptr, np.int64), np.ascontiguousarray(A.indices, np.int64),
        np.ascontiguousarray(A.data, np.float64), np.ascontiguousarray(T.indptr, np.int64),
        np.ascontiguousarray(T.indices, np.int64), np.ascontiguousarray(T.data, np.float64),
        n, g, theta, np.ascontiguousarray(virt, np.uint8), ids)
    return ids


def amd_order(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Minimum-degree ordering on the A+Aᵀ pattern; the same permutation as
    the oracle ``sparse/reorder.py: amd_permutation``."""
    perm = np.empty(n, dtype=np.int64)
    load().lssp_amd_order(np.ascontiguousarray(indptr, np.int64),
                          np.ascontiguousarray(indices, np.int64), n, perm)
    return perm


def splu(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n: int,
         pivot_tol: float, ztol: float, zval: float):
    """Left-looking sparse LU with threshold partial pivoting of the CSC
    matrix (indptr, indices, data).  Returns (Lp, Li, Lx, Up, Ui, Ux, pinv,
    nclamped): L unit-diagonal (not stored) and U with its diagonal, both
    CSC in pivot-row numbering; pinv maps an original row to its pivot
    position."""
    lib = load()
    info = ctypes.c_int64(0)
    h = lib.lssp_splu(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      n, pivot_tol, ztol, zval, ctypes.byref(info))
    lnnz, unnz = ctypes.c_int64(0), ctypes.c_int64(0)
    lib.lssp_splu_sizes(h, ctypes.byref(lnnz), ctypes.byref(unnz))
    Lp, Up = np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)
    Li, Lx = np.zeros(lnnz.value, np.int64), np.zeros(lnnz.value, np.float64)
    Ui, Ux = np.zeros(unnz.value, np.int64), np.zeros(unnz.value, np.float64)
    pinv = np.zeros(n, dtype=np.int64)
    lib.lssp_splu_fetch(h, Lp, Li, Lx, Up, Ui, Ux, pinv)
    lib.lssp_splu_free(h)
    return Lp, Li, Lx, Up, Ui, Ux, pinv, int(info.value)


def spqr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, m: int, n: int, b=None):
    """The George–Heath sparse QR merge loop (rows pre-ordered, columns
    pre-permuted by the caller).  Returns (Rp, Rj, Rx, crhs, res2): R as
    CSR by pivot row with the diagonal first in each row, Qᵀb and the
    squared residual when ``b`` is given."""
    lib = load()
    res2, rnnz = ctypes.c_double(0.0), ctypes.c_int64(0)
    bv = np.zeros(1, np.float64) if b is None else np.ascontiguousarray(b, np.float64)
    h = lib.lssp_spqr(np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int64),
                      np.ascontiguousarray(data, np.float64),
                      m, n, bv, 0 if b is None else 1, ctypes.byref(res2), ctypes.byref(rnnz))
    Rp = np.zeros(n + 1, dtype=np.int64)
    Rj = np.zeros(rnnz.value, dtype=np.int64)
    Rx = np.zeros(rnnz.value, dtype=np.float64)
    crhs = np.zeros(n, dtype=np.float64)
    lib.lssp_spqr_fetch(h, Rp, Rj, Rx, crhs)
    lib.lssp_spqr_free(h)
    return Rp, Rj, Rx, crhs, float(res2.value)


def _blas_ptr(modname: str, fname: str) -> int:
    """The raw function pointer behind ``scipy.linalg.<modname>``'s capsule
    for ``fname`` (Fortran calling convention)."""
    import importlib
    cap = importlib.import_module("scipy.linalg." + modname).__pyx_capi__[fname]
    get_name = ctypes.pythonapi.PyCapsule_GetName
    get_name.restype, get_name.argtypes = ctypes.c_char_p, [ctypes.py_object]
    get_ptr = ctypes.pythonapi.PyCapsule_GetPointer
    get_ptr.restype, get_ptr.argtypes = ctypes.c_void_p, [ctypes.py_object, ctypes.c_char_p]
    return get_ptr(cap, get_name(cap))


def mf_symbolic(Mp, Mi, n: int):
    """The multifrontal symbolic phase on the symmetrized, AMD-ordered
    pattern (oracle: ``pc/multifrontal.py: mf_symbolic``).  Returns (post,
    sn_start, sn_parent, rs_ptr, rs_idx), or None when the row sets
    outgrow every buffer tried."""
    lib = load()
    Mp = np.ascontiguousarray(Mp, np.int64)
    Mi = np.ascontiguousarray(Mi, np.int64)
    post = np.empty(n, dtype=np.int64)
    sn_start = np.empty(n + 1, dtype=np.int64)
    sn_parent = np.empty(n, dtype=np.int64)
    rs_ptr = np.empty(n + 1, dtype=np.int64)
    cap = int(4 * len(Mi) + 16 * n + 64)
    for _ in range(6):
        rs_idx = np.empty(cap, dtype=np.int64)
        nsn = lib.lssp_mf_symbolic(Mp, Mi, n, post, sn_start, sn_parent, rs_ptr, rs_idx, cap)
        if nsn >= 0:
            return (post, sn_start[:nsn + 1], sn_parent[:nsn], rs_ptr[:nsn + 1],
                    rs_idx[:rs_ptr[nsn]].copy())
        cap *= 2
    return None


def mf_numeric(B, C, sn_start, sn_parent, rs_ptr, rs_idx, ztol: float, zval: float):
    """The multifrontal numeric phase (oracle: ``pc/multifrontal.py:
    mf_factor_arrays``) on the permuted matrix as scipy CSR ``B`` and CSC
    ``C``.  Returns (Lr, Lc, Lv, Ur, Uc, Uv, rowof, nclamped), or None."""
    lib = load()
    n = B.shape[0]
    nsn = len(sn_start) - 1
    w = np.diff(sn_start)
    nR = np.diff(rs_ptr)
    capL = int((w * (w - 1) // 2 + (nR - w) * w).sum())
    capU = int((w * (w + 1) // 2 + (nR - w) * w).sum())
    Lr, Lc, Lv = np.empty(capL, np.int64), np.empty(capL, np.int64), np.empty(capL, np.float64)
    Ur, Uc, Uv = np.empty(capU, np.int64), np.empty(capU, np.int64), np.empty(capU, np.float64)
    rowof = np.empty(n, np.int64)
    out = lib.lssp_mf_numeric(
        np.ascontiguousarray(B.indptr, np.int64), np.ascontiguousarray(B.indices, np.int64),
        np.ascontiguousarray(B.data, np.float64), np.ascontiguousarray(C.indptr, np.int64),
        np.ascontiguousarray(C.indices, np.int64), np.ascontiguousarray(C.data, np.float64),
        n, np.ascontiguousarray(sn_start, np.int64), np.ascontiguousarray(sn_parent, np.int64),
        np.ascontiguousarray(rs_ptr, np.int64), np.ascontiguousarray(rs_idx, np.int64), nsn,
        ztol, zval, _blas_ptr("cython_blas", "dgemm"), _blas_ptr("cython_blas", "dtrsm"),
        _blas_ptr("cython_lapack", "dgetrf"), Lr, Lc, Lv, capL, Ur, Uc, Uv, capU, rowof)
    if out < 0:
        return None
    return Lr, Lc, Lv, Ur, Uc, Uv, rowof, int(out)
