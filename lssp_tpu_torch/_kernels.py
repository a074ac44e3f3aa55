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

import collections
import contextlib
import contextvars
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
# ptxas's report (registers, shared memory, spills) of each compile, kept
# in ``ptxas_log`` by source name when this process built the library
PTXAS_FLAGS = ["-Xptxas", "-v"]

# rows per thread block of K3 (csrc/hyb_spmv.cu: kThreads); HYB's
# remainder index is built for it on the host and checked at launch
HYB_BLOCK_ROWS = 256

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall seconds of this process's build, None if cached
ptxas_log = {}           # source basename -> nvcc's stderr, when built here


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


def _run_all(cmds) -> list:
    """Run the commands at once; raise if any fails or runs past 900 s,
    after ending those still running.  Returns each command's stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed, errs = [], []
    try:
        for cmd, proc in procs:
            out, err = proc.communicate(timeout=900)
            errs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _build() -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{_LIB_PATH}.{tag}"
    objs = [os.path.join(_BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in _sources()]
    t0 = time.perf_counter()
    try:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + PTXAS_FLAGS
        errs = _run_all([[nvcc_path(), *compile_flags, "-c", "-o", o, s]
                         for s, o in zip(_sources(), objs)])
        ptxas_log.update({os.path.basename(s): e for s, e in zip(_sources(), errs)})
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
            # K2 / K2k's launch prepared once a plan: per factor (band,
            # offsets, ndiag, strays ptr / cols / vals), invd, n, k,
            # ring_rows, mask, sweeps, rows, tiles, the wait sets (a host int
            # array), the two halos, kt, grid, and where to put the handle
            fn = getattr(lib, f"lssp_neumann_prepare_{suf}")
            fn.argtypes = ([p, p, i32, p, p, p] * 2 + [p] + [i64] * 4 + [i32] * 3
                           + [ctypes.POINTER(i32)] + [i32] * 4 + [ctypes.POINTER(p)])
            fn.restype = ctypes.c_int
            # one apply of it: handle, r, z0, out, levels, flags, stream
            fn = getattr(lib, f"lssp_neumann_run_{suf}")
            fn.argtypes = [p] * 7
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_neumann_release_{suf}")     # handle
            fn.argtypes = [p]
            fn.restype = None
            fn = getattr(lib, f"lssp_neumann_blocks_{suf}")     # kt, rows, hmax, ndmax
            fn.argtypes = [i32] * 4
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"lssp_neumann_rows_per_thread_{suf}")     # kt
            fn.argtypes = [i32]
            fn.restype = ctypes.c_int
        # K1 / K3 / K4 and their k-rhs forms K1k / K3k / K4k, also in bf16
        for suf in ("f32", "f64", "bf16"):
            fn = getattr(lib, f"lssp_dia_spmv_{suf}")
            fn.argtypes = [p, p, i32, i64, i64, p, f64, f64, p, p, p]
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
        # K1 / K3 bf16 through the band ring (csrc/band_ring.cuh): the
        # plain arguments, then threads, stages, grid, shared bytes, t_lo,
        # t_hi (ops/dia_spmv.py: TilePlan), stream
        ring = [i32, i32, i32, i32, i64, i64, p]
        lib.lssp_dia_spmv_ring_bf16.argtypes = [p, p, i32, i64, i64, p, f64, f64, p, p] + ring
        lib.lssp_dia_spmv_ring_bf16.restype = ctypes.c_int
        lib.lssp_hyb_spmv_ring_bf16.argtypes = ([p, p, i32, i64, i64, p, p, p, p, p, f64, f64,
                                                 p, p] + ring)
        lib.lssp_hyb_spmv_ring_bf16.restype = ctypes.c_int
        _lib = lib
        return _lib


def ptxas_lines(pattern: str) -> list:
    """ptxas's lines (registers, shared memory, spills) for the kernels whose
    mangled name holds ``pattern``, from this process's build; [] when the
    library was cached."""
    lines = []
    for src, err in sorted(ptxas_log.items()):
        keep = False
        for line in err.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                keep = pattern in line
            if keep:
                lines.append(f"{src}: {line.strip()}")
    return lines


_sms = {}


def num_sms(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (memoized)."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _sms[key]


SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# the dtypes of K2 / K2k (csrc/neumann.cu): the TPU kernel is fp32 only, and
# a bf16 inner solve applies K2 on an fp32 plan (ops/neumann.py)
NEUMANN_DTYPES = (torch.float32, torch.float64)


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


def kernel_dtype(name: str, t: torch.Tensor, dtypes=tuple(SUFFIX)):
    """The kernel entry suffix for ``t``'s dtype; raises on a dtype outside
    ``dtypes`` (every kernel but K2 takes float32, float64 and bfloat16)."""
    if t.dtype not in dtypes:
        names = ", ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got {t.dtype}")
    return SUFFIX[t.dtype]


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


# the launches a CUDA graph capture records (``recording``), or None
_recorded: contextvars.ContextVar = contextvars.ContextVar("recorded_launches", default=None)


def launched(counter, suf: str, route: str | None = None, shape: tuple | None = None) -> None:
    """Count one launch on the wrapper ``counter``: ``counter.launches``,
    and ``counter.by_dtype[suf]`` by entry suffix (f32, f64, bf16), so a run
    can show which precision's kernel its path took; with ``route`` (K1 and
    K3: "ring" or "rowwise") also ``counter.by_route[route]``, with
    ``shape`` (K4 and K4k: the launch's sizes) ``counter.by_shape[shape]``.
    Inside ``recording`` the launch is kept for the graph's replays
    instead."""
    recorded = _recorded.get()
    if recorded is not None:
        recorded[(counter, suf, route, shape)] += 1
        return
    _count(counter, suf, route, shape, 1)


def _count(counter, suf, route, shape, n):
    counter.launches += n
    counter.by_dtype[suf] = counter.by_dtype.get(suf, 0) + n
    if route is not None:
        counter.by_route[route] = counter.by_route.get(route, 0) + n
    if shape is not None:
        counter.by_shape[shape] = counter.by_shape.get(shape, 0) + n


@contextlib.contextmanager
def recording():
    """Within the block (a CUDA graph's capture, which launches nothing)
    the wrappers count no launch; each is kept in the yielded Counter,
    keyed (counter, suffix, route, shape), for ``replayed``."""
    recorded = collections.Counter()
    token = _recorded.set(recorded)
    try:
        yield recorded
    finally:
        _recorded.reset(token)


def replayed(recorded) -> None:
    """Count the launches ``recording`` kept once each: one replay of the
    graph whose capture they were."""
    for (counter, suf, route, shape), n in recorded.items():
        _count(counter, suf, route, shape, n)


# set by utils.debug.nan_guard: the ctypes launches are invisible to its
# TorchDispatchMode, so while it is on each wrapper checks its output here
nan_check = False


def check_nan(name: str, out: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` when ``nan_guard`` is on and the
    kernel's output ``out`` holds a NaN (one flag read a launch when off)."""
    if nan_check and bool(torch.isnan(out).any()):
        raise FloatingPointError(f"nan_guard: kernel {name} produced a NaN")
