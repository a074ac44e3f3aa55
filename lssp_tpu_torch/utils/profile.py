"""Profiling hooks (``lssp_tpu/utils/profile.py``): ``torch.profiler``
traces, the program's named spans, and the setup-phase ledger.

The reference times assemble and PC assemble separately
(reference src/lssp.cxx:162-184, pc.cxx:83-236); ``prepare_ir``,
the facade and the AMG setups fill the same ledger under JAX's phase
names, so a harness can itemize setup: ``reorder_convert``, ``upload``,
``pc_build`` (``solvers/refine.prepare_ir``), ``saamg_host_levels``,
``saamg_pack_upload``, ``saamg_coarse_inv`` (``amg/sa.py``),
``amg_host_levels`` and ``amg_pack_upload`` (``amg/rs.py``), and the
distributed build's ``dist_factor``, ``dist_partition`` and
``dist_upload`` (``parallel/dist_solve._build_dist``).

``annotate`` is the span every layer opens, all named ``lssp.*``: a
request (``lssp.solve``, ``lssp.solve_ir``, ``lssp.dist_solve_ir``, ... and
their ``_multi`` forms), ``lssp.memo.fingerprint``, each phase as
``lssp.<phase>``, ``lssp.ir.round``, ``lssp.krylov.inner``,
``lssp.pc.apply``, ``lssp.amg.level.<l>`` and ``lssp.comm.all_gather`` /
``all_to_all`` / ``p2p``.  A span is a host range on the profiler's own
clock, so a trace puts each of the device's idle gaps down to the spans
open at that moment; with no profiler recording it reads one flag.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _ap


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


_RecordFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The program's span ``name``, as a context manager.  While a
    ``torch.profiler`` records, a host range on its clock
    (``_RecordFunctionFast``, else ``record_function``); otherwise one flag
    read and a shared no-op context.  Under Nsight Systems, run the block
    inside ``torch.autograd.profiler.emit_nvtx()``: the spans are then
    NVTX ranges."""
    if not _ap._is_profiler_enabled:
        return _OFF
    if _RecordFast is not None:
        return _RecordFast(name)
    return _ap.record_function(name)


def amg_level(l: int) -> str:
    """The span name of AMG level ``l`` (0 the finest)."""
    return f"lssp.amg.level.{l}"


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
    """Add the block's wall seconds to the setup phase ``name``; the block
    is also the span ``lssp.<name>``."""
    t0 = time.perf_counter()
    try:
        with annotate("lssp." + name):
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
