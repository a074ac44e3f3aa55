"""BiCG — biconjugate gradients, the two-sided Lanczos method of the
reference's LASPACK and PETSc adapter tables (solver-laspack.cxx:29-34,
solver-petsc.cxx:23-32; ``lssp_tpu/solvers/bicg.py``): one product, one
Aᵀ·v, one M⁻¹ and one M⁻ᵀ apply an iteration, shadow r̃0 = r0.  A lane
whose ρ or σ falls to the breakdown threshold counts that iteration,
keeps x and r, and stops.

One body for the single-rhs and the per-column batched form (``lanes``):
each iteration reads ‖r‖, ρ and σ in one transfer."""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.solvers.base import (
    dot as base_dot, init_state, nonzero, norm, operator_t, pc_transpose,
)
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("bicg")
@register_solver("bicg")
def bicg(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    opt, pct = operator_t(A), pc_transpose(M)
    L = Lanes(b, r, opts, dot=dot)
    L.rel = True
    rt = r                                  # shadow residual r̃0 = r0
    p = pt = rho_old = None
    while L.active.any():
        z, zt = pc(r), pct(rt)
        rho = dot(zt, r)
        if p is None:
            p, pt = z, zt
        else:
            beta = rho / nonzero(rho_old)
            p, pt = z + beta * p, zt + beta * pt
        q, qt = op(p), opt(pt)
        sigma = dot(pt, q)
        alpha = rho / nonzero(sigma)
        r_new = r - alpha * q
        res, rho_h, sigma_h = L.read(norm(r_new, dot), rho, sigma)
        brk = (np.abs(rho_h) <= opts.breakdown) | (np.abs(sigma_h) <= opts.breakdown)
        x = L.pick(L.active & ~brk, x + alpha * p, x)
        r, rt = r_new, rt - alpha * qt
        L.advance(np.where(brk, L.res, res), done=brk)
        rho_old = rho
    return L.result(x)
