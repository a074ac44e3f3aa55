"""Exact sparse-LU preconditioner (and the engine of ``method="direct"``).

The port of ``lssp_tpu/pc/lu.py``: the LU factorization on the host
(``pc/lu_host.py``: Gilbert–Peierls or the supernodal multifrontal engine,
the same factors as JAX's), the exact level-scheduled triangular sweeps on
the device (``ops/trisolve.py``; an LU factor under a fill-reducing
ordering takes the compact layout).  One apply is an exact solve up to
pivot clamping: as a preconditioner it converges any Krylov method in one
iteration, and inside ``solve_ir`` it gives a direct solver with
fp64-quality answers from fp32 factors.  No kernel: JAX runs these sweeps
as a ``lax.scan`` in XLA, so they are plain torch here.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.ops.trisolve import (
    ilu_apply, ilu_apply_t, ilu_transpose_schedules, level_schedule,
)
from lssp_tpu_torch.pc.base import Preconditioner, register_pc
from lssp_tpu_torch.pc.lu_host import splu_factor


def _lu_apply(state, r):
    """(U⁻¹L⁻¹ r[perm_in])[perm_out], for r (n,) or an (n, k) block."""
    sl, su, perm_in, perm_out = state[:4]
    return ilu_apply(sl, su, r[perm_in])[perm_out]


def _lu_apply_t(state, r):
    """M⁻ᵀ for M⁻¹x = (U⁻¹L⁻¹ x[perm_in])[perm_out]: L⁻ᵀU⁻ᵀ with the
    permutations transposed (gather by the inverse of perm_out on input,
    of perm_in on output), both inverses built at setup."""
    if len(state) < 8:
        raise ValueError("LU transpose apply requires PCOptions(transpose=True) at setup")
    _, _, _, _, sut, slt, inv_out, inv_in = state
    return ilu_apply_t(sut, slt, r[inv_out])[inv_in]


def lu_state(f, dtype, device, transpose=False):
    """The apply state of a host factorization ``f`` (an ``SpLU``): the
    factors cast to ``dtype`` and scheduled on ``device``; with
    ``transpose`` also the schedules of Uᵀ and Lᵀ and the inverse
    permutations."""
    L = f.L.astype(dtype) if f.L.dtype != dtype else f.L
    U = f.U.astype(dtype) if f.U.dtype != dtype else f.U
    state = (level_schedule(L, lower=True, device=device),
             level_schedule(U, lower=False, device=device),
             torch.from_numpy(np.asarray(f.perm_in, np.int64)).to(device),
             torch.from_numpy(np.asarray(f.perm_out, np.int64)).to(device))
    if transpose:
        state = state + ilu_transpose_schedules(L, U, device=device) + (
            torch.from_numpy(np.argsort(f.perm_out).astype(np.int64)).to(device),
            torch.from_numpy(np.argsort(f.perm_in).astype(np.int64)).to(device))
    return state


@register_pc("lu")
def setup_lu(A, opts, device):
    """Factor A on the host (``lu_order``, ``lu_pivot_tol``, ``lu_method``)
    and schedule the factors, cast to A's dtype, on ``device``."""
    f = splu_factor(A, order=opts.lu_order, pivot_tol=opts.lu_pivot_tol, method=opts.lu_method)
    state = lu_state(f, np.asarray(A.data).dtype, device, transpose=opts.transpose)
    return Preconditioner(_lu_apply, state=state, name="lu", apply_t_fn=_lu_apply_t)
