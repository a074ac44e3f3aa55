"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled on first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, one nvcc per source started together, and
linked into ``lssp_tpu_torch/_build/libkernels.so`` (a plain C interface,
loaded with ctypes), under a lock, and rebuilt when a
source or header (``csrc/*.cuh``) is newer than the library.  Nothing here
runs at import time: the CPU never needs the library, because CPU tensors
take each kernel's plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libkernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# rows per thread block of K3 (csrc/hyb_spmv.cu: kThreads); HYB's
# remainder index is built for it on the host and checked at launch
HYB_BLOCK_ROWS = 256

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall seconds of this process's build, None if cached


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def _run_all(cmds) -> None:
    """Run the commands at once; raise if any fails or runs past 900 s,
    after ending those still running."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    try:
        for cmd, proc in procs:
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def _build() -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{_LIB_PATH}.{tag}"
    objs = [os.path.join(_BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in _sources()]
    t0 = time.perf_counter()
    try:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        _run_all([[nvcc_path(), *compile_flags, "-c", "-o", o, s]
                  for s, o in zip(_sources(), objs)])
        _run_all([[nvcc_path(), *NVCC_FLAGS, "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, _LIB_PATH)       # atomic: a concurrent loader sees old or new
    build_seconds = time.perf_counter() - t0


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    inputs = _sources() + glob.glob(os.path.join(_CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in inputs)


def load():
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        p, i64, i32, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
        for suf in ("f32", "f64"):
            fn = getattr(lib, f"lssp_dia_spmv_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
            # K2 / K2k: per factor (band, offsets, ndiag, strays ptr / cols /
            # vals), invd, n, k, r, z0, out, levels, ring_rows, mask, flags,
            # sweeps, rows, tiles, the wait sets (a host int array), the two
            # halos, kt, grid, stream
            fn = getattr(lib, f"lssp_neumann_apply_{suf}")
            fn.argtypes = ([p, p, i32, p, p, p] * 2 + [p, i64, i64, p, p, p, p, i64, i64, p]
                           + [i32] * 3 + [ctypes.POINTER(i32)] + [i32] * 4 + [p])
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_neumann_blocks_{suf}")     # kt, rows, hmax, ndmax
            fn.argtypes = [i32] * 4
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_neumann_rows_per_thread_{suf}")     # kt
            fn.argtypes = [i32]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_hyb_spmv_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, p, p, p, p, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_dia_spmv_ext_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, i64, i64, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
            # the k-rhs forms K1k-K4k: one more int64, k, after the sizes
            fn = getattr(lib, f"lssp_dia_spmm_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, i64, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_hyb_spmm_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, i64, p, p, p, p, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_dia_spmm_ext_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, i64, i64, i64, p, f64, f64, p, p, p]
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_block(name: str, X: torch.Tensor, dtype, rows: int) -> int:
    """Raise unless ``X`` is an (rows, k) block in the layout of
    ``ops/spmv.py`` (row-major, contiguous, on CUDA, of ``dtype``); returns
    k.  A non-contiguous block is rejected, never copied."""
    if not isinstance(X, torch.Tensor) or X.ndim != 2:
        raise ValueError(f"{name}: expected an (n, k) block, got "
                         f"{tuple(getattr(X, 'shape', ()))}")
    check_cuda(name, X, dtype, (rows, X.shape[1]))
    return int(X.shape[1])


def kernel_dtype(name: str, t: torch.Tensor):
    """The kernel entry suffix for ``t``'s dtype; raises on other dtypes."""
    if t.dtype not in SUFFIX:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"got {t.dtype}")
    return SUFFIX[t.dtype]


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
