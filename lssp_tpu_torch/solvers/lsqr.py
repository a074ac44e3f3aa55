"""LSQR — Paige–Saunders Golub–Kahan bidiagonalization with the QR update
(damp = 0), the reference's PETSc adapter method (solver-petsc.cxx:23-32;
``lssp_tpu/solvers/lsqr.py``): one product and one Aᵀ·v an iteration.
For a square nonsingular A it solves Ax = b; for a rectangular A (m, n)
it converges to the least-squares solution, b of length m and x of
length n (the iterate lives in the column space).  A given M is a right
preconditioner through M⁻ᵀ.

The loop runs on φ̄ (‖b − Ax‖ in exact arithmetic) and stops when a lane's
α falls to the breakdown threshold; at the end the true residual is
recomputed and reported, and convergence is judged on it.  One body for
the single-rhs and the per-column batched form (``lanes``): each
iteration reads φ̄ and α in one transfer; a stopped lane keeps its y."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, norm, operator, operator_t, pc_transpose
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("lsqr")
@register_solver("lsqr")
def lsqr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    a_op, a_opt = operator(A), operator_t(A)
    if M is None:
        op, opt = a_op, a_opt
    else:
        pct = pc_transpose(M)
        op, opt = (lambda v: a_op(M(v))), (lambda v: pct(a_opt(v)))
    tiny = torch.finfo(b.dtype).tiny
    r0 = b - a_op(x0) if x0 is not None else b - 0.0 * b
    L = Lanes(b, r0, opts, dot=dot)
    L.rel = True
    beta = norm(r0, dot)
    u = r0 / torch.clamp(beta, min=tiny)
    v = opt(u)
    alfa = norm(v, dot)
    v = v / torch.clamp(alfa, min=tiny)
    y, w, rhobar, phibar = torch.zeros_like(v), v, alfa, beta
    (alfa_h,) = L.read(alfa)
    L.settle(alfa_h <= opts.breakdown)
    while L.active.any():
        u = op(v) - alfa * u                # the bidiagonalization step
        beta = norm(u, dot)
        u = u / torch.clamp(beta, min=tiny)
        v_new = opt(u) - beta * v
        alfa = norm(v_new, dot)
        v = v_new / torch.clamp(alfa, min=tiny)
        rho = torch.clamp(torch.sqrt(rhobar * rhobar + beta * beta), min=tiny)
        c, s = rhobar / rho, beta / rho     # the plane rotation
        theta = s * alfa
        rhobar = -c * alfa
        phi, phibar = c * phibar, s * phibar
        y = L.pick(L.active, y + (phi / rho) * w, y)
        w = v - (theta / rho) * w
        phibar_h, alfa_h = L.read(phibar, alfa)
        L.advance(np.abs(phibar_h), done=alfa_h <= opts.breakdown)
    x = y if M is None else M(y)
    if x0 is not None:
        x = x0 + x
    (res,) = L.read(norm(b - a_op(x), dot))
    return L.result(x, residual=res, converged=res <= L.tol)
