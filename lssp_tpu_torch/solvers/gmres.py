"""GMRES(m), left- and right-preconditioned.

Left (reference lssp_solver_gmres, solver-gmres.cxx:12-255):
preconditioned Arnoldi with modified Gram–Schmidt, Givens rotations, the
adaptive inner tolerance ``gstol`` re-estimated each restart (:220), a true
residual at every restart (:206-215), and the h ≤ breakdown rule that
discards the current column (:152).  Right (lssp_solver_gmres_r,
:257-479): the PC before the SpMV, convergence on the Givens estimate,
update ``x += M⁻¹(V·y)``.

The basis and its inner products stay on the device.  Each Arnoldi step
brings its Hessenberg column to the host once (one sync); the Givens
recurrence and the small triangular solve run there in numpy, in the
solve's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, history_init, history_update, init_state, norm, stopping_tol,
)
from lssp_tpu_torch.solvers.registry import register_solver
from lssp_tpu_torch.sparse.types import numpy_dtype


def _arnoldi_cycle(op, pc, v0, beta_p, m, maxit, itr, gstol, right, breakdown):
    """One restart cycle.  Returns (V, H, gg, kk, itr, gs_norm); ``kk`` is
    the number of usable columns (a broken-down column is dropped)."""
    dt = numpy_dtype(v0.dtype).type
    V = v0.new_zeros((m, v0.shape[0]))
    V[0] = v0
    H = np.zeros((m + 1, m), dt)
    gg = np.zeros(m + 1, dt)
    gg[0] = beta_p
    c = np.zeros(m, dt)
    s = np.zeros(m, dt)
    kk, gs_norm = 0, dt(np.inf)
    i = 0
    while i < m and (not right or itr < maxit):
        itr += 1
        w = op(pc(V[i])) if right else pc(op(V[i]))
        hs = []
        for j in range(i + 1):              # modified Gram–Schmidt
            hij = torch.dot(w, V[j])
            w = w - hij * V[j]
            hs.append(hij)
        hnorm = norm(w)
        hcol = np.zeros(m + 1, dt)
        hcol[:i + 2] = torch.stack(hs + [hnorm]).cpu().numpy()
        brk = abs(hcol[i + 1]) <= breakdown
        if not brk and i + 1 < m:
            V[i + 1] = w / hnorm
        for j in range(i):                  # accumulated Givens rotations
            h1 = c[j] * hcol[j] + s[j] * hcol[j + 1]
            h2 = -s[j] * hcol[j] + c[j] * hcol[j + 1]
            hcol[j], hcol[j + 1] = h1, h2
        gma = np.sqrt(hcol[i] ** 2 + hcol[i + 1] ** 2)
        if gma == 0.0:
            gma = dt(1e-20)
        ci, si = hcol[i] / gma, hcol[i + 1] / gma
        if brk:                             # the reference discards column i
            break
        gg[i], gg[i + 1] = ci * gg[i], -si * gg[i]
        hcol[i] = ci * hcol[i] + si * hcol[i + 1]
        H[:, i] = hcol
        c[i], s[i] = ci, si
        kk, gs_norm = i + 1, abs(gg[i + 1])
        i += 1
        if gs_norm <= gstol:
            break
    return V, H, gg, kk, itr, gs_norm


def _solve_ym(H, gg, kk, m):
    """Back-substitute the kk×kk rotated Hessenberg system; ym[i]=0 for i≥kk."""
    gg = gg.copy()
    ym = np.zeros(m, gg.dtype)
    for i in range(kk - 1, -1, -1):
        denom = H[i, i] if H[i, i] != 0.0 else gg.dtype.type(1.0)
        ym[i] = gg[i] / denom
        gg[:i] -= ym[i] * H[:i, i]
    return ym


def _gmres(A, b, x0, M, opts, right):
    m, maxit = opts.restart, opts.maxit
    op, pc, x, rg = init_state(A, b, x0, M)
    dt = numpy_dtype(b.dtype).type
    tiny = np.finfo(dt).tiny
    bnorm = norm(b).item()
    beta0 = norm(rg).item()
    tol = dt(stopping_tol(beta0, bnorm, opts))
    rtol = tol / max(dt(beta0), tiny)
    hist = history_init(opts, beta0)
    itr, beta, gstol = 0, dt(beta0), dt(0.0)
    while itr < maxit and beta > tol:
        if right:
            bp = norm(rg)
            v0 = rg / bp
        else:
            z0 = pc(rg)
            bp = norm(z0)
            v0 = z0 / bp
        bp = dt(bp.item())
        if not right and itr == 0:          # first cycle seeds gstol
            gstol = rtol * bp * dt(0.5)
        V, H, gg, kk, itr, gs_norm = _arnoldi_cycle(
            op, pc, v0, bp, m, maxit, itr, tol if right else gstol, right,
            opts.breakdown)
        ym = _solve_ym(H, gg, kk, m)
        vy = torch.from_numpy(ym[:kk]).to(V.device) @ V[:kk]
        if right:
            x = x + pc(vy)
            beta = gs_norm                  # the Givens estimate is the residual
            rg = b - op(x)
        else:
            x = x + vy
            rg = b - op(x)
            beta = dt(norm(rg).item())      # true residual each restart
            safe = max(beta / max(dt(beta0), tiny), tiny)
            gstol = rtol * gs_norm / safe * dt(0.5)
        history_update(opts, hist, itr, float(beta))
    return x, SolveInfo(nits=itr, residual=float(beta), converged=bool(beta <= tol),
                        r0norm=beta0, bnorm=bnorm, history=hist)


@register_solver("gmres")
def gmres(A, b, x0=None, M=None, opts=None):
    """Left-preconditioned GMRES(m) (reference LSSP_SOLVER_GMRES)."""
    return _gmres(A, b, x0, M, opts, right=False)


@register_solver("rgmres")
def gmres_r(A, b, x0=None, M=None, opts=None):
    """Right-preconditioned GMRES(m) (reference LSSP_SOLVER_RGMRES)."""
    return _gmres(A, b, x0, M, opts, right=True)
