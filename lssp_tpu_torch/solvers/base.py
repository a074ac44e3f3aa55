"""Shared solver skeleton.

The reference's pattern (reference solver-cg.cxx): resolve options →
r0 = b − A·x0 → threshold ``max(rtol·‖r0‖, atol, rbtol·‖b‖)`` (:66-70) →
iterate → report residual and iteration count.  The iteration is a Python
``while`` loop; each solver reads its convergence scalar to the host once
per iteration (one device sync), and scalars that only feed device math
stay 0-d tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from lssp_tpu_torch.ops.spmv import spmv


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    """Result metadata (reference solver.residual / solver.nits)."""

    nits: int               # iteration count
    residual: float         # final residual norm ‖b−Ax‖ (or the method's estimate)
    converged: bool
    r0norm: float           # initial residual norm
    bnorm: float            # ‖b‖
    history: Any = None     # optional (maxit+1,) residual trace, NaN-padded


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def operator(A) -> Callable:
    """Wrap a matrix container (or callable) as x ↦ A@x."""
    if callable(A) and not hasattr(A, "shape"):
        return A
    return lambda v: spmv(A, v)


def stopping_tol(r0norm: float, bnorm: float, opts) -> float:
    """tol = max(rtol·‖r0‖, atol, rbtol·‖b‖) (reference solver-cg.cxx:66-70)."""
    return max(max(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)


def identity_pc(r):
    """PC_NONE: solve = copy (reference pc.cxx:67-79)."""
    return r


def init_state(A, b, x0, M):
    """Common init: operators, x0 defaults to 0, r0 = b − A x0."""
    op = operator(A)
    pc = M if M is not None else identity_pc
    x = torch.zeros_like(b) if x0 is None else x0
    return op, pc, x, b - op(x)


def history_init(opts, r0norm: float) -> Optional[np.ndarray]:
    """NaN-padded (maxit+1,) residual trace, or None when not recorded."""
    if not opts.record_history:
        return None
    h = np.full(opts.maxit + 1, np.nan)
    h[0] = r0norm
    return h


def history_update(opts, hist, it: int, res: float, r0norm=None, bnorm=None) -> None:
    """Record the trace and, at verbosity >= 1, print the reference's
    per-iteration line (reference solver-cg.cxx:108-112)."""
    if opts.verbosity >= 1:
        if r0norm is not None and bnorm is not None:
            tiny = np.finfo(np.float64).tiny
            print(f"itr: {it:5d}, abs res: {res:.6e}, rel res: "
                  f"{res / max(r0norm, tiny):.6e}, rbn: {res / max(bnorm, tiny):.6e}")
        else:
            print(f"itr: {it:5d}, abs res: {res:.6e}")
    if hist is not None and it < len(hist):
        hist[it] = res
