"""Conjugate Gradient (reference lssp_solver_cg, solver-cg.cxx:8-136).

Left-preconditioned Hestenes–Stiefel CG with the reference's iteration
structure (z = M⁻¹r → ρ = ⟨z,r⟩ → β-update of p → q = Ap → α = ρ/⟨q,p⟩ →
x, r update → ‖r‖ check), so iteration counts compare with ``lssp_tpu``.
"""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, history_init, history_update, init_state, norm, stopping_tol,
)
from lssp_tpu_torch.solvers.registry import register_solver


@register_solver("cg")
def cg(A, b, x0=None, M=None, opts=None):
    op, pc, x, r = init_state(A, b, x0, M)
    bnorm = norm(b).item()
    r0norm = norm(r).item()
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)
    it, res = 0, r0norm
    p = rho_old = None
    while it < opts.maxit and res > tol:
        z = pc(r)
        rho = torch.dot(z, r)
        p = z if it == 0 else z + (rho / rho_old) * p
        q = op(p)
        alpha = rho / torch.dot(q, p)
        x = x + alpha * p
        r = r - alpha * q
        res = norm(r).item()
        it += 1
        rho_old = rho
        history_update(opts, hist, it, res, r0norm, bnorm)
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm, history=hist)
