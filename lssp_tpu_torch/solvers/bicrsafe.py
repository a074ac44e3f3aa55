"""BiCRSafe (reference lssp_solver_bicrsafe, solver-bicrsafe.cxx:4-151):
the CR analog of BiCGSafe, with the extra shadow ar̃ = A·r̃ (:52) and
ρ = ⟨r̃, A·M⁻¹r⟩.  One body for the single-rhs and the per-column batched
form (``lanes``)."""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.bicgsafe import qsi_eta
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("bicrsafe")
@register_solver("bicrsafe")
def bicrsafe(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    rtld = r
    artld = op(rtld)
    p = mr = pc(r)
    ap = amr = op(mr)
    rho_old = dot(rtld, amr)
    y = my = u = z = torch.zeros_like(r)
    beta = L.scalar(0.0, b)
    first = True
    while L.active.any():
        map_ = pc(ap)
        alpha = rho_old / nonzero(dot(artld, map_))
        qsi, eta = qsi_eta(first, y, amr, r, dot)
        u = (eta * beta) * u + qsi * map_ + eta * my      # (:82-85)
        au = op(u)
        z = eta * z + qsi * mr - alpha * u
        y = eta * y + qsi * amr - alpha * au
        my = pc(y)
        x_new = x + alpha * p + z
        r = r - alpha * ap - y
        mr_new = mr - alpha * map_ - my
        amr_new = op(mr_new)
        rho = dot(rtld, amr_new)
        res, rho_h = L.read(norm(r, dot), rho)
        x = L.pick(L.active, x_new, x)
        L.advance(res, done=rho_h == 0.0)
        if L.active.any():
            beta = (rho / nonzero(rho_old)) * (alpha / nonzero(qsi))
            p = mr_new + beta * (p - u)
            ap = amr_new + beta * (ap - au)
            mr, amr = mr_new, amr_new
        rho_old, first = rho, False
    return L.result(x)
