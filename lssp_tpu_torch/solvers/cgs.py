"""CGS — Conjugate Gradient Squared (reference lssp_solver_cgs,
solver-cgs.cxx:4-133): shadow r̃ = r0, the ρ == 0 and ⟨r̃, v̂⟩ == 0
breakdown exits.  One body for the single-rhs and the per-column batched
form (``lanes``): each iteration reads ‖r‖, ρ and ⟨r̃, v̂⟩ in one transfer;
a lane that breaks down keeps its x and stops."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("cgs")
@register_solver("cgs")
def cgs(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    rtld = r
    p = q = torch.zeros_like(r)
    rho_old = L.scalar(1.0, b)
    while L.active.any():
        rho = dot(rtld, r)
        beta = rho / nonzero(rho_old)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        vhat = op(pc(p))
        tdot = dot(rtld, vhat)
        alpha = rho / nonzero(tdot)
        q = u - alpha * vhat
        uhat = pc(u + q)
        x_new = x + alpha * uhat
        r_new = r - alpha * op(uhat)
        res, rho_h, tdot_h = L.read(norm(r_new, dot), rho, tdot)
        fail = (rho_h == 0.0) | (tdot_h == 0.0)
        x = L.pick(L.active & ~fail, x_new, x)
        r = r_new
        L.advance(np.where(fail, L.res, res), done=fail)
        rho_old = rho
    return L.result(x)
