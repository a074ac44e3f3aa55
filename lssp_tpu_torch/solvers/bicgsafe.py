"""BiCGSafe (reference lssp_solver_bicgsafe, solver-bicgsafe.cxx:4-155): a
product-type method whose (ζ, η) pair minimizes the residual over two
directions from five dot products (:64-77); the ρ == 0 breakdown exit.
One body for the single-rhs and the per-column batched form (``lanes``)."""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


def qsi_eta(first, y, ay, r, dot):
    """The reference's (ζ, η) from the five dots of y, ay = A·M⁻¹(r or t)
    and r: on the first iteration ζ = ⟨ay, r⟩/⟨ay, ay⟩ and η = 0."""
    t1, t4 = dot(ay, r), dot(ay, ay)
    if first:                               # y = 0: the other three dots vanish
        return t1 / nonzero(t4), torch.zeros_like(t1)
    t0, t2, t3 = dot(y, y), dot(y, r), dot(ay, y)
    tmp = nonzero(t4 * t0 - t3 * t3)
    return (t0 * t1 - t2 * t3) / tmp, (t4 * t2 - t3 * t1) / tmp


@register_batched("bicgsafe")
@register_solver("bicgsafe")
def bicgsafe(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    rtld = r
    p = mr = pc(r)
    ap = amr = op(mr)
    rho_old = dot(rtld, r)
    y = u = z = torch.zeros_like(r)
    beta = L.scalar(0.0, b)
    first = True
    while L.active.any():
        alpha = rho_old / nonzero(dot(rtld, ap))
        qsi, eta = qsi_eta(first, y, amr, r, dot)
        mt = pc(eta * y + qsi * ap)
        u = mt + (eta * beta) * u
        au = op(u)
        z = qsi * mr + eta * z - alpha * u
        y = qsi * amr + eta * y - alpha * au
        x_new = x + alpha * p + z
        r = r - alpha * ap - y
        rho = dot(rtld, r)
        res, rho_h = L.read(norm(r, dot), rho)
        x = L.pick(L.active, x_new, x)
        L.advance(res, done=rho_h == 0.0)
        if L.active.any():
            beta = (rho / nonzero(rho_old)) * (alpha / nonzero(qsi))
            mr = pc(r)
            amr = op(mr)
            p = mr + beta * (p - u)
            ap = amr + beta * (ap - au)
        rho_old, first = rho, False
    return L.result(x)
