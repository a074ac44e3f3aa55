"""BiCGSTAB (reference lssp_solver_bicgstab, solver-bicgstab.cxx:10-175):
the preconditioner applied to the direction vectors p and s; the ρ == 0
failure exit (:89-92) and the ‖s‖ ≤ breakdown early-update exit
(:117-128).  Besides the convergence read, each iteration brings the two
breakdown flags to the host together (a second sync) to pick the branch."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, dot as base_dot, history_init, history_init_block, history_update,
    history_update_block, init_state, norm, stopping_tol, to_host,
)
from lssp_tpu_torch.solvers.base import dot, nonzero as _nonzero, norm
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_solver("bicgstab")
def bicgstab(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    bnorm = norm(b, dot).item()
    r0norm = norm(r, dot).item()
    tol = stopping_tol(r0norm, bnorm, opts)
    hist = history_init(opts, r0norm)
    rh = r                                   # shadow residual r̂ = r0
    it, res, done = 0, r0norm, False
    p = v = rho0 = alpha = omega = None
    while it < opts.maxit and res > tol and not done:
        rho1 = dot(r, rh)
        if it == 0:
            p = r
        else:
            beta = (rho1 * alpha) / _nonzero(rho0 * omega)
            p = r + beta * (p - omega * v)
        ph = pc(p)
        v = op(ph)
        alpha = rho1 / _nonzero(dot(rh, v))
        s = r - alpha * v
        fail, s_small = torch.stack([rho1 == 0.0, norm(s, dot) <= opts.breakdown]).tolist()
        if fail:                             # ρ = 0: stop, x and r unchanged
            done = True
        elif s_small:                        # ‖s‖-breakdown: half-update, exit
            x = x + alpha * ph
            r = b - op(x)
            done = True
        else:
            sh = pc(s)
            t = op(sh)
            omega = dot(t, s) / _nonzero(dot(t, t))
            x = x + alpha * ph + omega * sh
            r = s - omega * t
        rho0 = rho1
        res = norm(r, dot).item()
        it += 1
        history_update(opts, hist, it, res)
    return x, SolveInfo(nits=it, residual=res, converged=res <= tol,
                        r0norm=r0norm, bnorm=bnorm, history=hist)


@register_batched("bicgstab")
def bicgstab_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """BiCGSTAB on every column of an (n, k) block, each column on its own
    single-rhs trajectory (the per-column path of ``solve_multi``, as
    ``cg_batched``).  A column stops at its tolerance, at maxit, or at its
    own ρ = 0 or ‖s‖-breakdown exit; the k breakdown flags come to the host
    together (a second sync, as in ``bicgstab``) to pick each column's
    branch."""
    op, pc, X, R = init_state(A, B, X0, M)
    r0_t = norm(R, dot)
    bnorm, r0norm = to_host(norm(B, dot), r0_t)
    tol = np.maximum(np.maximum(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)
    tol_t = torch.from_numpy(tol).to(B.device)
    hist = history_init_block(opts, B.shape[1], r0norm)
    it = np.zeros(B.shape[1], np.int64)
    res = r0norm.copy()
    active = (it < opts.maxit) & (res > tol)
    act_t = (r0_t.double() > tol_t) & (opts.maxit > 0)
    it_t = torch.zeros_like(act_t, dtype=torch.int64)
    Rh = R                                   # shadow residuals r̂ = r0
    P = V = rho0 = alpha = omega = None
    first = True
    while active.any():
        rho1 = dot(R, Rh)
        if first:
            P = R
        else:
            beta = (rho1 * alpha) / _nonzero(rho0 * omega)
            P = R + beta * (P - omega * V)
        Ph = pc(P)
        V = op(Ph)
        alpha = rho1 / _nonzero(dot(Rh, V))
        S = R - alpha * V
        fail_t = act_t & (rho1 == 0.0)
        small_t = act_t & ~fail_t & (norm(S, dot) <= opts.breakdown)
        full_t = act_t & ~fail_t & ~small_t
        fail, small = (f.astype(bool) for f in to_host(fail_t, small_t))
        if (active & ~fail & ~small).any():
            Sh = pc(S)
            T = op(Sh)
            omega = dot(T, S) / _nonzero(dot(T, T))
            X = torch.where(full_t, X + alpha * Ph + omega * Sh, X)
            R = torch.where(full_t, S - omega * T, R)
        if small.any():                      # ‖s‖-breakdown: half-update, exit
            Xh = torch.where(small_t, X + alpha * Ph, X)
            R = torch.where(small_t, B - op(Xh), R)
            X = Xh
        rho0, first = rho1, False
        res_t = norm(R, dot)
        it_t = it_t + act_t
        act_t = full_t & (res_t.double() > tol_t) & (it_t < opts.maxit)
        res_h, act_h = to_host(res_t, act_t)
        it += active
        res = np.where(active, res_h, res)
        history_update_block(opts, hist, it, res, cols=active)
        active = act_h.astype(bool)
    return X, SolveInfo(nits=it, residual=res, converged=res <= tol, r0norm=r0norm,
                        bnorm=bnorm, history=hist)
