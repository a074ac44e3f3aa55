"""BiCGSTAB(l) (reference lssp_solver_bicgstabl, solver-bicgstabl.cxx:4-217):
right preconditioning in disguise: the recurrence runs on A∘M⁻¹
(:99-100, 138-139) with the iterate x̂ in the preconditioned variable,
and x = M⁻¹x̂ + x0 at exit (:130-134, 189-194).  Each outer step is l
BiCG steps, each one counted, each ending in one host read (ρ, ν, ‖r‖),
then the minimal-residual (MR) polynomial part (:143-186), whose l×l
recurrences stay on the device as 0-d (or (k,)) tensors and end in one
read of the new ‖r‖.  l = ``opts.bgsl``.  The BiCG steps do not test
maxit, so a count may pass it by up to l − 1, as in the reference.

One body for the single-rhs and the per-column batched form (``lanes``).
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


def _mr(R, U, xh, l, dot):
    """The MR part on the residuals R[0..l] and directions U[0..l] (lists):
    modified Gram–Schmidt on R[1..l], the γ, γ′, γ″ recurrences and the
    update.  Returns (x̂, R, U, ω)."""
    R = list(R)
    tau = [[None] * (l + 1) for _ in range(l + 1)]
    sigma = [None] * (l + 1)
    gamma1 = [None] * (l + 1)
    for j in range(1, l + 1):
        for i in range(1, j):
            nu = dot(R[j], R[i]) / sigma[i]
            tau[i][j] = nu
            R[j] = R[j] - nu * R[i]
        sigma[j] = dot(R[j], R[j])
        gamma1[j] = dot(R[0], R[j]) / nonzero(sigma[j])
    gamma = [None] * (l + 1)
    gamma[l] = gamma1[l]
    for j in range(l - 1, 0, -1):
        acc = sum(tau[j][m] * gamma[m] for m in range(j + 1, l + 1))
        gamma[j] = gamma1[j] - acc
    gamma2 = [None] * (l + 1)
    for j in range(1, l):
        acc = sum(tau[j][m] * gamma[m + 1] for m in range(j + 1, l))
        gamma2[j] = gamma[j + 1] + acc
    # UPDATE (:174-186)
    xh = xh + gamma[1] * R[0]
    r0 = R[0] - gamma1[l] * R[l]
    u0 = U[0] - gamma[l] * U[l]
    for j in range(1, l):
        u0 = u0 - gamma[j] * U[j]
        xh = xh + gamma2[j] * R[j]
        r0 = r0 - gamma1[j] * R[j]
    R[0] = r0
    U = [u0] + list(U[1:])
    return xh, R, U, gamma1[l]


@register_batched("bicgstabl")
@register_solver("bicgstabl")
def bicgstabl(A, b, x0=None, M=None, opts=None, dot=base_dot):
    l = opts.bgsl
    op, pc, xp, r0 = init_state(A, b, x0, M)
    L = Lanes(b, r0, opts, limit=opts.maxit + 1, dot=dot)
    rtld = r0
    xh = torch.zeros_like(b)
    zero = torch.zeros_like(b)
    R = [r0] + [zero] * l
    U = [zero] * (l + 1)
    alpha = L.scalar(0.0, b)
    omega = rho0 = L.scalar(1.0, b)
    while L.active.any():
        rho0 = -omega * rho0
        stop = ~L.active
        for j in range(l):                  # the BiCG part
            rho1 = dot(rtld, R[j])
            beta = alpha * (rho1 / nonzero(rho0))
            U = [R[i] - beta * U[i] for i in range(j + 1)] + U[j + 1:]
            U[j + 1] = op(pc(U[j]))
            nu = dot(rtld, U[j + 1])
            alpha = rho1 / nonzero(nu)
            xh_n = xh + alpha * U[0]
            R = [R[i] - alpha * U[i + 1] for i in range(j + 1)] + R[j + 1:]
            rho1_h, nu_h, nrm = L.read(rho1, nu, norm(R[0], dot))
            fail = (rho1_h == 0.0) | (nu_h == 0.0)
            go = ~stop & ~fail
            xh = L.pick(go, xh_n, xh)
            L.count(go, nrm)
            stop = stop | fail | (go & (nrm <= L.tol))
            rho0 = rho1
            if stop.all():
                break
            R[j + 1] = op(pc(R[j]))
        go = ~stop
        if go.any():                        # the MR part
            xh_n, R, U, omega = _mr(R, U, xh, l, dot)
            xh = L.pick(go, xh_n, xh)
            (res,) = L.read(norm(R[0], dot))
            L.res = np.where(go, res, L.res)
            L.record(go)
        L.settle(stop)
    return L.result(pc(xh) + xp)
