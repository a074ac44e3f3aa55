"""Conjugate Gradient (reference lssp_solver_cg, solver-cg.cxx:8-136).

Left-preconditioned Hestenes–Stiefel CG with the reference's iteration
structure (z = M⁻¹r → ρ = ⟨z,r⟩ → β-update of p → q = Ap → α = ρ/⟨q,p⟩ →
x, r update → ‖r‖ check), so iteration counts compare with ``lssp_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, dot as base_dot, history_init, history_init_block, history_update,
    history_update_block, init_state, norm, stopping_tol, to_host,
)
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_solver("cg")
def cg(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    bnorm = norm(b, dot).item()
    r0norm = norm(r, dot).item()
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)
    it, res = 0, r0norm
    p = rho_old = None
    while it < opts.maxit and res > tol:
        z = pc(r)
        rho = dot(z, r)
        p = z if it == 0 else z + (rho / rho_old) * p
        q = op(p)
        alpha = rho / dot(q, p)
        x = x + alpha * p
        r = r - alpha * q
        res = norm(r, dot).item()
        it += 1
        rho_old = rho
        history_update(opts, hist, it, res, r0norm, bnorm)
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm, history=hist)


@register_batched("cg")
def cg_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """CG on every column of an (n, k) block: the per-column path of
    ``solve_multi`` (JAX runs ``jax.vmap(cg)``).  Each column follows its
    own single-rhs trajectory and keeps its own count: a column whose
    stopping rule is met stops updating (``torch.where`` on X and R) while
    the others go on, as a vmapped ``while_loop`` keeps a finished lane's
    carry.  The matrix and preconditioner stream once per iteration for
    all k columns; one host sync per iteration brings the k residuals and
    the active mask over together."""
    op, pc, X, R = init_state(A, B, X0, M)
    r0_t = norm(R, dot)
    bnorm, r0norm = to_host(norm(B, dot), r0_t)
    tol = np.maximum(np.maximum(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)
    tol_t = torch.from_numpy(tol).to(B.device)
    hist = history_init_block(opts, B.shape[1], r0norm)
    it = np.zeros(B.shape[1], np.int64)
    res = r0norm.copy()
    active = (it < opts.maxit) & (res > tol)
    act_t = (r0_t.double() > tol_t) & (opts.maxit > 0)
    it_t = torch.zeros_like(act_t, dtype=torch.int64)
    P = rho_old = None
    first = True
    while active.any():
        Z = pc(R)
        rho = dot(Z, R)
        P = Z if first else Z + (rho / rho_old) * P
        Q = op(P)
        alpha = rho / dot(Q, P)
        X = torch.where(act_t, X + alpha * P, X)
        R = torch.where(act_t, R - alpha * Q, R)
        rho_old, first = rho, False
        res_t = norm(R, dot)
        it_t = it_t + act_t
        act_t = act_t & (res_t.double() > tol_t) & (it_t < opts.maxit)
        res_h, act_h = to_host(res_t, act_t)
        it += active
        res = np.where(active, res_h, res)
        history_update_block(opts, hist, it, res, r0norm, bnorm, cols=active)
        active = act_h.astype(bool)
    return X, SolveInfo(nits=it, residual=res, converged=res <= tol, r0norm=r0norm,
                        bnorm=bnorm, history=hist)
