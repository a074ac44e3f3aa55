"""Profiling hooks (``lssp_tpu/utils/profile.py``): ``torch.profiler``
traces and ranges, derived SpMV throughput, and the setup-phase ledger.

The reference times assemble and PC assemble separately
(reference src/lssp.cxx:162-184, pc.cxx:83-236); ``prepare_ir``,
the facade and the AMG setups fill the same ledger under JAX's phase
names, so a harness can itemize setup: ``reorder_convert``, ``upload``,
``pc_build`` (``solvers/refine.prepare_ir``), ``saamg_host_levels``,
``saamg_pack_upload``, ``saamg_coarse_inv`` (``amg/sa.py``),
``amg_host_levels`` and ``amg_pack_upload`` (``amg/rs.py``).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when ``device`` or the current default is a CUDA device) and
    write it to ``logdir`` as a Chrome trace (open in Perfetto or
    chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the trace: ``torch.profiler.record_function``, and
    an NVTX range when CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def spmv_counters(A, seconds: float, iters: int = 1) -> dict:
    """Derived throughput of an SpMV-bound phase: nnz/s and effective GB/s
    under the standard traffic model (values and indices read once, x read
    once, y written once)."""
    nnz = int(A.nnz)
    n = int(A.shape[0])
    dt = A.dtype
    itemsize = (dt.itemsize if isinstance(dt, torch.dtype)
                else getattr(np.dtype(dt), "itemsize", 8))
    bytes_per = nnz * itemsize + nnz * 4 + 2 * n * itemsize
    t = seconds / max(1, iters)
    return {"nnz_per_s": nnz / t, "gbytes_per_s": bytes_per / t / 1e9,
            "seconds_per_iter": t}


def enable_persistent_cache(warn=True):
    """The directory where the port's CUDA kernels are built and kept
    (``_kernels._BUILD_DIR``), its only persistent compile cache: a later
    process loads the library from there instead of compiling again.  JAX
    points XLA's compilation cache somewhere; the port has nothing else to
    configure.  ``warn`` is accepted for JAX's signature."""
    from lssp_tpu_torch import _kernels
    return _kernels._BUILD_DIR


_phase_times: dict = {}
_phase_bytes: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Add the block's wall seconds to the setup phase ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _phase_times[name] = _phase_times.get(name, 0.0) + time.perf_counter() - t0


def add_bytes(name: str, nbytes: int) -> None:
    """Attribute ``nbytes`` of host-to-device upload to the phase ``name``."""
    _phase_bytes[name] = _phase_bytes.get(name, 0) + int(nbytes)


def tree_device_bytes(tree) -> int:
    """Total bytes of the tensors and numpy arrays inside ``tree``
    (dataclasses, tuples, lists and dicts are walked)."""
    from lssp_tpu_torch.utils.tree import array_leaves
    return sum(int(a.nbytes) for a in array_leaves(tree))


def reset_phases() -> None:
    _phase_times.clear()
    _phase_bytes.clear()


def phase_times() -> dict:
    """Snapshot of the {phase: seconds} ledger."""
    return dict(_phase_times)


def phase_bytes() -> dict:
    """Snapshot of the {phase: bytes uploaded} ledger."""
    return dict(_phase_bytes)
