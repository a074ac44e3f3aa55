"""QMR — quasi-minimal residual (Freund–Nachtigal, no look-ahead), the
reference's LASPACK adapter method (solver-laspack.cxx:29-34;
``lssp_tpu/solvers/qmr.py``): the coupled two-term recurrence with the
preconditioner split M1 = M (left), M2 = I, the shadow sequence through
Aᵀ and M⁻ᵀ.  Every textbook breakdown test (ρ, ξ, δ, ε, β, γ) ends the
lane: it counts that iteration and keeps x.

One body for the single-rhs and the per-column batched form (``lanes``):
each iteration reads ‖r‖ and the six breakdown scalars in one transfer."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    dot as base_dot, init_state, nonzero, norm, operator_t, pc_transpose,
)
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("qmr")
@register_solver("qmr")
def qmr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    opt, pct = operator_t(A), pc_transpose(M)
    L = Lanes(b, r, opts, dot=dot)
    L.rel = True
    tiny = torch.finfo(b.dtype).tiny
    vt = wt = z = r                         # M2 = I: z = M2⁻ᵀ w̃ = w̃
    y = pc(vt)
    rho, xi = norm(y, dot), norm(z, dot)
    gamma, eta = L.scalar(1.0, b), L.scalar(-1.0, b)
    theta, eps = L.scalar(0.0, b), L.scalar(1.0, b)
    p = q = d = s = None
    while L.active.any():
        v, yv = vt / nonzero(rho), y / nonzero(rho)
        w, zv = wt / nonzero(xi), z / nonzero(xi)
        delta = dot(zv, yv)
        zt = pct(zv)                        # yt = M2⁻¹ y = y
        if p is None:
            p, q = yv, zt
        else:
            p = yv - (xi * delta / nonzero(eps)) * p
            q = zt - (rho * delta / nonzero(eps)) * q
        pt = op(p)
        eps_n = dot(q, pt)
        beta = eps_n / nonzero(delta)
        safe_beta = nonzero(beta)
        vt = pt - safe_beta * v
        y = pc(vt)
        rho_n = norm(y, dot)
        wt = opt(q) - safe_beta * w
        z = wt
        xi_n = norm(z, dot)
        theta_n = rho_n / torch.clamp(gamma * torch.abs(safe_beta), min=tiny)
        gamma_n = 1.0 / torch.sqrt(1.0 + theta_n * theta_n)
        eta_n = -eta * rho * gamma_n * gamma_n / (safe_beta * torch.clamp(gamma * gamma,
                                                                          min=tiny))
        if d is None:
            d, s = eta_n * p, eta_n * pt
        else:
            tg2 = (theta * gamma_n) ** 2
            d, s = eta_n * p + tg2 * d, eta_n * pt + tg2 * s
        r_new = r - s
        res, *scal = L.read(norm(r_new, dot), rho, xi, delta, eps_n, beta, gamma_n)
        brk = np.any([np.abs(v_) <= opts.breakdown for v_ in scal], axis=0)
        x = L.pick(L.active & ~brk, x + d, x)
        r = r_new
        L.advance(np.where(brk, L.res, res), done=brk)
        rho, xi, gamma, eta, theta, eps = rho_n, xi_n, gamma_n, eta_n, theta_n, eps_n
    return L.result(x)
