"""CR — Conjugate Residual (reference lssp_solver_cr, solver-cr.cxx:4-115),
preconditioned through q̃ = M⁻¹q; the ρ = ⟨q̃, q⟩ == 0 breakdown exit.
One body for the single-rhs and the per-column batched form (``lanes``)."""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("cr")
@register_solver("cr")
def cr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    p = z = pc(r)
    q = op(p)
    while L.active.any():
        qtld = pc(q)
        rho = dot(qtld, q)
        alpha = dot(r, qtld) / nonzero(rho)
        x_new = x + alpha * p
        r = r - alpha * q
        res, rho_h = L.read(norm(r, dot), rho)
        fail = rho_h == 0.0
        x = L.pick(L.active & ~fail, x_new, x)
        L.advance(np.where(fail, L.res, res), done=fail)
        if L.active.any():
            z = z - alpha * qtld
            az = op(z)
            beta = -dot(az, qtld) / nonzero(rho)
            p = z + beta * p
            q = az + beta * q
    return L.result(x)
