"""CRS — Conjugate Residual Squared (reference lssp_solver_crs,
solver-crs.cxx:4-109): shadow r̃ = A·r0 (:45), the ρ == 0 and
⟨r̃, M⁻¹Ap⟩ == 0 breakdown exits.  One body for the single-rhs and the
per-column batched form (``lanes``)."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("crs")
@register_solver("crs")
def crs(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    rtld = op(r)                            # shadow = A·r0
    p = q = torch.zeros_like(r)
    rho_old = L.scalar(1.0, b)
    while L.active.any():
        z = pc(r)
        rho = dot(rtld, z)
        beta = rho / nonzero(rho_old)
        u = z + beta * q
        p = u + beta * (q + beta * p)
        map_ = pc(op(p))
        tdot = dot(rtld, map_)
        alpha = rho / nonzero(tdot)
        q = u - alpha * map_
        uq = u + q
        x_new = x + alpha * uq
        r = r - alpha * op(uq)
        res, rho_h, tdot_h = L.read(norm(r, dot), rho, tdot)
        fail = (rho_h == 0.0) | (tdot_h == 0.0)
        x = L.pick(L.active & ~fail, x_new, x)
        L.advance(np.where(fail, L.res, res), done=fail)
        rho_old = rho
    return L.result(x)
