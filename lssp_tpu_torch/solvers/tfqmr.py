"""TFQMR — Transpose-Free QMR (reference lssp_solver_tfqmr,
solver-tfqmr.cxx:4-149): two quasi-minimization half-steps an iteration
(m = 0, 1; :84-113) with the τ/θ/η recurrence and the residual estimate
τ·√(m+1) (:104); an iteration that converges after its first half stops
there.  The breakdown exits are ⟨v, r̃⟩ == 0 and ρ == 0.  As in the
reference the count starts at 1 and the loop runs while it ≤ maxit.

One body for the single-rhs and the per-column batched form (``lanes``):
both halves are computed, and one read per iteration (the two estimates,
⟨v, r̃⟩ and the next ρ) picks the half each lane stops at."""
from __future__ import annotations

import math

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


def _half(y, d, tau, theta, eta, alpha, ww):
    """One quasi-minimization half-step: (d, τ, θ, η) and η's step d."""
    d = y + (theta * theta * eta / nonzero(alpha)) * d
    theta = ww / nonzero(tau)
    c = 1.0 / torch.sqrt(1.0 + theta * theta)
    return d, tau * theta * c, theta, c * c * alpha


@register_batched("tfqmr")
@register_solver("tfqmr")
def tfqmr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, limit=opts.maxit + 1, it0=1, dot=dot)
    rtld = u = p = r
    v = op(pc(p))
    rho_old = dot(r, rtld)
    tau = w_old = norm(r, dot)
    theta = eta = L.scalar(0.0, b)
    d = torch.zeros_like(r)
    while L.active.any():
        s = dot(v, rtld)
        alpha = rho_old / nonzero(s)
        q = u - alpha * v
        r = r - alpha * op(pc(u + q))
        w = norm(r, dot)
        d0, tau0, theta0, eta0 = _half(u, d, tau, theta, eta, alpha, torch.sqrt(w * w_old))
        x0_ = x + eta0 * pc(d0)
        d, tau, theta, eta = _half(q, d0, tau0, theta0, eta0, alpha, w)
        x1_ = x0_ + eta * pc(d)
        rho = dot(r, rtld)
        s_h, res0, res1, rho_h = L.read(s, tau0, tau * math.sqrt(2.0), rho)
        stop1 = res0 <= L.tol               # converged after the first half
        x = L.pick(L.active & stop1, x0_, L.pick(L.active, x1_, x))
        res = np.where(stop1, res0, res1)
        L.advance(res, done=(s_h == 0.0) | (rho_h == 0.0) | stop1)
        if L.active.any():
            beta = rho / nonzero(rho_old)
            u = r + beta * q
            p = u + beta * (q + beta * p)
            v = op(pc(p))
        rho_old, w_old = rho, w
    return L.result(x)
