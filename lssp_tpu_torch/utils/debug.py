"""Numerics debugging aids (``lssp_tpu/utils/debug.py``): a NaN guard and a
host-side finiteness check."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _first_nan(out):
    """Whether a floating tensor in an op's output holds a NaN."""
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_first_nan(o) for o in out)
    return False


# ops whose output is uninitialized memory, which may hold any bit pattern
_UNINITIALIZED = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "resize_"))


class _NanMode(TorchDispatchMode):
    """Sees every aten op, in-place ones included, and raises at the first
    whose output holds a NaN.  Views are not checked (they produce no
    value, and may show a buffer not yet written), nor are allocations of
    uninitialized memory."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        if _first_nan(out):
            raise FloatingPointError(f"nan_guard: {func} produced a NaN")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise ``FloatingPointError`` at the first NaN an op produces inside
    the block, as JAX's ``jax_debug_nans`` does:

        with nan_guard():
            x, info = lt.solve(A, b, method="bicgstab", device="cpu")

    Every torch op is checked through a ``TorchDispatchMode``.  The
    hand-written CUDA kernels are ctypes calls no mode sees: while the
    guard is on, their wrappers check each output themselves
    (``_kernels.check_nan``, one flag read a launch when it is off).  Each
    check reads a flag back from the card, so a guarded solve is slow."""
    from lssp_tpu_torch import _kernels
    prev = _kernels.nan_check
    _kernels.nan_check = True
    try:
        with _NanMode():
            yield
    finally:
        _kernels.nan_check = prev


def check_finite(x, what: str = "array"):
    """Raise ``FloatingPointError`` unless every entry of ``x`` (a tensor or
    anything numpy takes) is finite, naming the count and the first bad
    index; returns ``x``."""
    a = x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    bad = ~np.isfinite(a)
    if bad.any():
        raise FloatingPointError(f"{what} contains {int(bad.sum())} non-finite entries "
                                 f"(first at index {int(np.flatnonzero(bad)[0])})")
    return x
