"""MINRES — minimal residual for symmetric (possibly indefinite) systems,
as in the reference's PETSc adapter table (solver-petsc.cxx:23-32): the
Paige–Saunders preconditioned Lanczos recurrence with a Givens QR of the
tridiagonal, one product and one preconditioner apply an iteration.
Needs a symmetric A and an SPD M.

The Lanczos loop runs on φ̄, the residual in the M-norm.  An outer loop
recomputes the true residual ‖b − Ax‖ and, while it is above the
stopping rule, restarts the Lanczos process from x with a 10× tighter
inner tolerance; a pass that makes no step because the entry M-norm β₁
vanished ends the solve.

One body for the single-rhs and the per-column batched form (``lanes``):
each Lanczos step reads φ̄ and β once; in the batched form a lane whose
Lanczos loop ended waits, x kept, until every lane's has, and then all
restart together, as under JAX's ``vmap``."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("minres")
@register_solver("minres")
def minres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r0 = init_state(A, b, x0, M)
    L = Lanes(b, r0, opts, dot=dot)
    L.rel = True
    tiny = torch.finfo(b.dtype).tiny
    inner_tol = L.tol.copy()
    stalled = np.zeros(L.shape, bool)
    while L.active.any():
        outer = L.active
        it0 = L.it
        r1 = b - op(x)
        y = pc(r1)
        beta = torch.sqrt(torch.clamp(dot(r1, y), min=0.0))
        (beta1,) = L.read(beta)
        r2 = r1
        w = w2 = torch.zeros_like(b)
        oldb = dbar = epsln = sn = L.scalar(0.0, b)
        cs = L.scalar(-1.0, b)
        phibar = beta
        first = True
        inner = outer & (L.it < opts.maxit) & (np.abs(beta1) > inner_tol) \
            & (beta1 > opts.breakdown)
        while inner.any():                  # the Lanczos / Givens recurrence
            v = (1.0 / torch.clamp(beta, min=tiny)) * y
            yn = op(v)
            if not first:                   # the previous Lanczos direction
                yn = yn - (beta / torch.clamp(oldb, min=tiny)) * r1
            alfa = dot(v, yn)
            yn = yn - (alfa / torch.clamp(beta, min=tiny)) * r2
            r1, r2 = r2, yn
            y = pc(yn)
            oldb, beta = beta, torch.sqrt(torch.clamp(dot(r2, y), min=0.0))
            oldeps = epsln
            delta = cs * dbar + sn * alfa   # plane rotation of the tridiagonal column
            gbar = sn * dbar - cs * alfa
            epsln = sn * beta
            dbar = -cs * beta
            gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=tiny)
            cs, sn = gbar / gamma, beta / gamma
            phi, phibar = cs * phibar, sn * phibar
            w1, w2 = w2, w
            w = (v - oldeps * w1 - delta * w2) / gamma
            x = L.pick(inner, x + phi * w, x)
            phibar_h, beta_h = L.read(phibar, beta)
            L.it = L.it + inner
            L.record(inner, np.abs(phibar_h))
            first = False
            inner = inner & (L.it < opts.maxit) & (np.abs(phibar_h) > inner_tol) \
                & (beta_h > opts.breakdown)
        (res,) = L.read(norm(b - op(x), dot))
        L.res = np.where(outer, res, L.res)
        stalled = np.where(outer, (L.it == it0) & (beta1 <= opts.breakdown), stalled)
        inner_tol = np.where(outer, inner_tol * 0.1, inner_tol)
        L.settle(stalled)
    return L.result(x)
