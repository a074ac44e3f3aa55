"""BiCGSTAB (reference lssp_solver_bicgstab, solver-bicgstab.cxx:10-175):
the preconditioner applied to the direction vectors p and s; the ρ == 0
failure exit (:89-92) and the ‖s‖ ≤ breakdown early-update exit
(:117-128).  Besides the convergence read, each iteration brings the two
breakdown flags to the host together (a second sync) to pick the branch."""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, history_init, history_update, init_state, norm, stopping_tol,
)
from lssp_tpu_torch.solvers.registry import register_solver


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    """t where t ≠ 0, else 1 (the reference's guarded divisions)."""
    return torch.where(t == 0.0, torch.ones_like(t), t)


@register_solver("bicgstab")
def bicgstab(A, b, x0=None, M=None, opts=None):
    op, pc, x, r = init_state(A, b, x0, M)
    bnorm = norm(b).item()
    r0norm = norm(r).item()
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)
    rh = r                                   # shadow residual r̂ = r0
    it, res, done = 0, r0norm, False
    p = v = rho0 = alpha = omega = None
    while it < opts.maxit and res > tol and not done:
        rho1 = torch.dot(r, rh)
        if it == 0:
            p = r
        else:
            beta = (rho1 * alpha) / _nonzero(rho0 * omega)
            p = r + beta * (p - omega * v)
        ph = pc(p)
        v = op(ph)
        alpha = rho1 / _nonzero(torch.dot(rh, v))
        s = r - alpha * v
        fail, s_small = torch.stack([rho1 == 0.0, norm(s) <= opts.breakdown]).tolist()
        if fail:                             # ρ = 0: stop, x and r unchanged
            done = True
        elif s_small:                        # ‖s‖-breakdown: half-update, exit
            x = x + alpha * ph
            r = b - op(x)
            done = True
        else:
            sh = pc(s)
            t = op(sh)
            omega = torch.dot(t, s) / _nonzero(torch.dot(t, t))
            x = x + alpha * ph + omega * sh
            r = s - omega * t
        rho0 = rho1
        res = norm(r).item()
        it += 1
        history_update(opts, hist, it, res)
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm, history=hist)
