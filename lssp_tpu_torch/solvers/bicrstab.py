"""BiCRSTAB (reference lssp_solver_bicrstab, solver-bicrstab.cxx:4-114):
the CR analog of BiCGSTAB with shadow r̃ = A·r0 (:44) and the early exit
on ‖s‖ ≤ tol with x += αp only (:61-64).  One body for the single-rhs and
the per-column batched form (``lanes``): each iteration reads ‖s‖, the
full step's ‖r‖ and the next ρ in one transfer."""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("bicrstab")
@register_solver("bicrstab")
def bicrstab(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    rtld = op(r)
    p = z = pc(r)
    rho_old = dot(rtld, z)
    while L.active.any():
        ap = op(p)
        map_ = pc(ap)
        alpha = rho_old / nonzero(dot(rtld, map_))
        s = r - alpha * ap
        ms = z - alpha * map_
        ams = op(ms)
        omega = dot(ams, s) / nonzero(dot(ams, ams))
        x_half = x + alpha * p
        x_full = x_half + omega * ms
        r = s - omega * ams
        z = pc(r)
        rho = dot(rtld, z)
        snorm, rnorm, rho_h = L.read(norm(s, dot), norm(r, dot), rho)
        early = snorm <= L.tol              # ‖s‖ converged: x += αp only, and stop
        x = L.pick(L.active & early, x_half, L.pick(L.active, x_full, x))
        res = np.where(early, snorm, rnorm)
        L.advance(res, done=(rho_h == 0.0) & ~early)
        if L.active.any():
            beta = (rho / nonzero(rho_old)) * (alpha / nonzero(omega))
            p = z + beta * (p - omega * map_)
        rho_old = rho
    return L.result(x)
