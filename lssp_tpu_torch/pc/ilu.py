"""ILU(0) / ILU(k) / ILUT / ILUTP preconditioners: host factorization,
device apply (reference assemble pc-iluk.cxx:566-581, pc-ilut.cxx:429-456;
apply contract lssp_pc_ilu_solve, solver-tri.cxx:48-60)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from lssp_tpu_torch.ops.neumann import (
    fused_neumann_apply, plan_fused_neumann, plan_fused_neumann_t,
)
from lssp_tpu_torch.ops.trisolve import (
    default_ilu_sweeps, ilu_apply, ilu_apply_t, ilu_transpose_schedules,
    level_schedule, neumann_exact_depth,
)
from lssp_tpu_torch.pc.base import Preconditioner, register_pc, round_factor
from lssp_tpu_torch.pc.ilu_host import iluk_factor, ilut_factor, ilutp_factor
from lssp_tpu_torch.sparse.utils import split_ldu


def _ilu_apply_fn(state, r):
    return ilu_apply(state[0], state[1], r)


def _ilu_apply_t_fn(state, r):
    if len(state) < 4:
        raise ValueError("ILU transpose apply requires PCOptions(transpose=True) at setup")
    return ilu_apply_t(state[2], state[3], r)


def _fused_apply_fn(state, r):
    return fused_neumann_apply(state[0], r)


def _fused_apply_t_fn(state, r):
    return fused_neumann_apply(state[1], r)


def make_ilu_pc(L, U, name, sweeps=None, transpose=False, device="cpu"):
    """Wrap host L/U factors as a Preconditioner with its state on ``device``.

    sweeps=0: exact level-scheduled triangular solves.
    sweeps>0: k Neumann sweeps per factor through kernel K2
    (``fused_neumann_apply``); ``transpose`` also builds the transposed
    plan (``plan_fused_neumann_t``), so that M⁻ᵀ is K2's apply on it
    (JAX keeps this apply in XLA; the plan costs the factors' bytes once
    more on the device, so it is built only when asked).
    sweeps=-1: exact through the complete Neumann series (the strict factors
    are nilpotent, so their dependency depth in sweeps is exact).
    sweeps=None: 6 on CUDA, exact on the CPU.
    A bfloat16 setup (``pc.base.value_dtype``) rounds L and U to bf16 here,
    before the plan or the schedules are formed from them."""
    L, U = round_factor(L), round_factor(U)
    if sweeps is None:
        sweeps = default_ilu_sweeps(device)
    if sweeps == -1:
        tris = []
        for T, lower in ((L, True), (U, False)):
            Ls, _, Us = split_ldu(T)
            S = Ls if lower else Us
            tris.append((S.indptr, S.indices, T.shape[0], lower))
        sweeps = neumann_exact_depth(tris)
    if sweeps > 0:
        plan = plan_fused_neumann(L, U, sweeps, device=device)
        if not transpose:
            return Preconditioner(fused_neumann_apply, state=plan, name=f"{name}-fn{sweeps}")
        return Preconditioner(_fused_apply_fn, state=(plan, plan_fused_neumann_t(
            L, U, sweeps, device=device)), name=f"{name}-fn{sweeps}",
            apply_t_fn=_fused_apply_t_fn)
    state = (level_schedule(L, lower=True, device=device),
             level_schedule(U, lower=False, device=device))
    if transpose:
        state = state + ilu_transpose_schedules(L, U, device=device)
    # the transpose fn raises when the transposed schedules were not built,
    # instead of silently applying the forward M⁻¹
    return Preconditioner(_ilu_apply_fn, state=state, name=name,
                          apply_t_fn=_ilu_apply_t_fn)


@register_pc("iluk")
def setup_iluk(A, opts, device):
    L, U = iluk_factor(A, level=opts.iluk_level, num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, f"iluk({opts.iluk_level})", opts.ilu_sweeps,
                       transpose=opts.transpose, device=device)


@register_pc("ilu0")
def setup_ilu0(A, opts, device):
    L, U = iluk_factor(A, level=0, num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, "ilu0", opts.ilu_sweeps, transpose=opts.transpose,
                       device=device)


@register_pc("ilut")
def setup_ilut(A, opts, device):
    L, U = ilut_factor(A, tol=opts.ilut_tol, p=opts.ilut_p,
                       num_blocks=opts.num_blocks or 1)
    return make_ilu_pc(L, U, "ilut", opts.ilu_sweeps, transpose=opts.transpose,
                       device=device)


def _ilutp_apply(inner_fn, state, r):
    inner_state, iperm, perm = state
    return inner_fn(inner_state, r)[iperm]      # undo the column pivoting


def _ilutp_apply_t(inner_t_fn, state, r):
    # M⁻¹ = G·U⁻¹L⁻¹ with (Gy)[c] = y[iperm[c]], so M⁻ᵀ = L⁻ᵀU⁻ᵀ·Gᵀ, Gᵀr = r[perm]
    inner_state, iperm, perm = state
    return inner_t_fn(inner_state, r[perm])


@register_pc("ilutp")
def setup_ilutp(A, opts, device):
    """ILUT with column pivoting (the LIS ``ilutp``), robust on matrices with
    small or zero diagonals: L·U ≈ A[:, perm] from the host heap loop
    (``ilutp_factor``), the permuted factors in A's dtype through
    ``make_ilu_pc`` (exact level schedules, or K2's Neumann sweeps and, for
    M⁻ᵀ, K2 on the transposed plan of the same factors applied to r[perm]),
    the permutation undone by a gather."""
    L, U, perm = ilutp_factor(A, tol=opts.ilut_tol, p=opts.ilut_p, permtol=opts.ilutp_permtol)
    dtype = np.asarray(A.data).dtype
    inner = make_ilu_pc(CSRcast(L, dtype), CSRcast(U, dtype), "ilutp-inner", opts.ilu_sweeps,
                        transpose=opts.transpose, device=device)
    state = (inner.state, torch.from_numpy(np.argsort(perm)).to(device),
             torch.from_numpy(np.asarray(perm, np.int64)).to(device))
    return Preconditioner(functools.partial(_ilutp_apply, inner.apply_fn), state=state,
                          name=f"ilutp[{inner.name}]",
                          apply_t_fn=(functools.partial(_ilutp_apply_t, inner.apply_t_fn)
                                      if inner.apply_t_fn is not None else None))


def CSRcast(T, dtype):
    """``T`` with its values in the numpy ``dtype`` (``T`` itself when they
    already are), JAX's helper of the same name."""
    if np.asarray(T.data).dtype == dtype:
        return T
    return T.astype(dtype)
