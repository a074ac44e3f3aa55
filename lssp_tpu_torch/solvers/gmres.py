"""GMRES(m), left- and right-preconditioned.

Left (reference lssp_solver_gmres, solver-gmres.cxx:12-255):
preconditioned Arnoldi with modified Gram–Schmidt, Givens rotations, the
adaptive inner tolerance ``gstol`` re-estimated each restart (:220), a true
residual at every restart (:206-215), and the h ≤ breakdown rule that
discards the current column (:152).  Right (lssp_solver_gmres_r,
:257-479): the PC before the SpMV, convergence on the Givens estimate,
update ``x += M⁻¹(V·y)``.  ``cagmres`` / ``cargmres`` orthogonalize by
twice-iterated classical Gram–Schmidt (CGS2) in place of MGS.

The basis and its inner products stay on the device.  Each Arnoldi step
brings its Hessenberg column to the host once (one sync); the Givens
recurrence and the small triangular solve run there in numpy, in the
solve's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, dot as base_dot, dot_rows, history_init, history_init_block, history_update,
    history_update_block, init_state, nonzero, norm, stopping_tol, to_host,
)
from lssp_tpu_torch.solvers.lanes import combine
from lssp_tpu_torch.solvers.registry import register_batched, register_solver
from lssp_tpu_torch.sparse.types import host_dtype


def _orthogonalize(dot, V, w, i, cgs2):
    """w against the basis rows V[0..i]: modified Gram–Schmidt, i+1
    dependent dots; or (``cgs2``) twice-iterated classical Gram–Schmidt,
    all i+1 coefficients of a pass from one ``dot_rows`` (one reduction
    over the shards on a mesh), MGS-grade orthogonality.  Returns (w, the
    i+1 coefficients stacked, ‖w‖)."""
    if cgs2:
        Vi = V[:i + 1]
        h1 = dot_rows(dot, Vi, w)
        w = w - combine(h1, Vi)
        h2 = dot_rows(dot, Vi, w)
        w = w - combine(h2, Vi)
        h = h1 + h2
    else:
        hs = []
        for j in range(i + 1):
            hij = dot(w, V[j])
            w = w - hij * V[j]
            hs.append(hij)
        h = torch.stack(hs)
    return w, h, torch.sqrt(dot(w, w))


def _arnoldi_cycle(op, pc, v0, beta_p, m, maxit, itr, gstol, right, breakdown,
                   dot=base_dot, cgs2=False):
    """One restart cycle.  Returns (V, H, gg, kk, itr, gs_norm); ``kk`` is
    the number of usable columns (a broken-down column is dropped)."""
    dt = host_dtype(v0.dtype).type
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
        w, h, hnorm = _orthogonalize(dot, V, w, i, cgs2)
        hcol = np.zeros(m + 1, dt)
        hcol[:i + 2] = torch.cat([h, hnorm[None]]).cpu().to(torch.float64).numpy()
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


def _gmres(A, b, x0, M, opts, right, dot=base_dot, cgs2=False):
    m, maxit = opts.restart, opts.maxit
    op, pc, x, rg = init_state(A, b, x0, M)
    dt = host_dtype(b.dtype).type
    tiny = np.finfo(dt).tiny
    bnorm = norm(b, dot).item()
    beta0 = norm(rg, dot).item()
    tol = dt(stopping_tol(beta0, bnorm, opts))
    rtol = tol / max(dt(beta0), tiny)
    hist = history_init(opts, beta0)
    itr, beta, gstol = 0, dt(beta0), dt(0.0)
    while itr < maxit and beta > tol:
        if right:
            bp = norm(rg, dot)
            v0 = rg / bp
        else:
            z0 = pc(rg)
            bp = norm(z0, dot)
            v0 = z0 / bp
        bp = dt(bp.item())
        if not right and itr == 0:          # first cycle seeds gstol
            gstol = rtol * bp * dt(0.5)
        V, H, gg, kk, itr, gs_norm = _arnoldi_cycle(
            op, pc, v0, bp, m, maxit, itr, tol if right else gstol, right,
            opts.breakdown, dot, cgs2)
        ym = _solve_ym(H, gg, kk, m)
        vy = torch.from_numpy(ym[:kk]).to(V.device, V.dtype) @ V[:kk]
        if right:
            x = x + pc(vy)
            beta = gs_norm                  # the Givens estimate is the residual
            rg = b - op(x)
        else:
            x = x + vy
            rg = b - op(x)
            beta = dt(norm(rg, dot).item())     # true residual each restart
            safe = max(beta / max(dt(beta0), tiny), tiny)
            gstol = rtol * gs_norm / safe * dt(0.5)
        history_update(opts, hist, itr, float(beta))
    return x, SolveInfo(nits=itr, residual=float(beta), converged=bool(beta <= tol),
                        r0norm=beta0, bnorm=bnorm, history=hist)


@register_solver("gmres")
def gmres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Left-preconditioned GMRES(m) (reference LSSP_SOLVER_GMRES)."""
    return _gmres(A, b, x0, M, opts, right=False, dot=dot)


@register_solver("rgmres")
def gmres_r(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Right-preconditioned GMRES(m) (reference LSSP_SOLVER_RGMRES)."""
    return _gmres(A, b, x0, M, opts, right=True, dot=dot)


@register_solver("cagmres")
def cagmres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Communication-avoiding (merged-dot) GMRES(m): CGS2 orthogonalization,
    three reductions an Arnoldi column whatever its index (MGS pays i+1
    dependent dots), the latency answer for restarted GMRES on a mesh;
    counts match gmres.  No reference analog (the reference is serial)."""
    return _gmres(A, b, x0, M, opts, right=False, dot=dot, cgs2=True)


@register_solver("cargmres")
def cargmres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Right-preconditioned merged-dot GMRES(m) (see cagmres), the variant
    ``solve_ir`` runs for a cagmres inner solve."""
    return _gmres(A, b, x0, M, opts, right=True, dot=dot, cgs2=True)


def _givens_step(hcol, i, c, s, gg, breakdown, dt):
    """Column i of one rhs's Arnoldi cycle through its accumulated Givens
    rotations (``_arnoldi_cycle``'s host arithmetic).  Returns (broke
    down, ci, si); on no breakdown ``gg`` and ``hcol`` are updated."""
    brk = abs(hcol[i + 1]) <= breakdown
    for j in range(i):
        h1 = c[j] * hcol[j] + s[j] * hcol[j + 1]
        h2 = -s[j] * hcol[j] + c[j] * hcol[j + 1]
        hcol[j], hcol[j + 1] = h1, h2
    gma = np.sqrt(hcol[i] ** 2 + hcol[i + 1] ** 2)
    if gma == 0.0:
        gma = dt(1e-20)
    ci, si = hcol[i] / gma, hcol[i + 1] / gma
    if not brk:
        gg[i], gg[i + 1] = ci * gg[i], -si * gg[i]
        hcol[i] = ci * hcol[i] + si * hcol[i + 1]
    return brk, ci, si


def _arnoldi_cycle_batched(op, pc, V0, beta_p, m, maxit, itr, gstol, right, breakdown,
                           live, dot, cgs2=False):
    """``_arnoldi_cycle`` on every column in the mask ``live`` at once: the
    products and Gram-Schmidt run on the (n, k) block, the Givens
    recurrence on the host per column, and a column leaves the inner loop
    on its own breakdown or tolerance while the others go on.  Returns
    (V (m, n, k), H (k, m+1, m), gg (k, m+1), kk (k,), itr, gs_norm)."""
    dt = host_dtype(V0.dtype).type
    n, k = V0.shape
    V = V0.new_zeros((m, n, k))
    V[0] = V0
    H = np.zeros((k, m + 1, m), dt)
    gg = np.zeros((k, m + 1), dt)
    gg[:, 0] = beta_p
    c = np.zeros((k, m), dt)
    s = np.zeros((k, m), dt)
    kk = np.zeros(k, np.int64)
    gs_norm = np.full(k, np.inf, dt)
    itr, inner = itr.copy(), live.copy()
    for i in range(m):
        if right:
            inner &= itr < maxit
        if not inner.any():
            break
        itr += inner
        w = op(pc(V[i])) if right else pc(op(V[i]))
        w, h, hnorm = _orthogonalize(dot, V, w, i, cgs2)        # per column
        hcols = torch.cat([h, hnorm[None]]).cpu().to(torch.float64).numpy()   # (i+2, k)
        if i + 1 < m:                       # a column that broke down never reads it
            V[i + 1] = w / nonzero(hnorm)
        for col in np.flatnonzero(inner):
            hcol = np.zeros(m + 1, dt)
            hcol[:i + 2] = hcols[:, col]
            brk, ci, si = _givens_step(hcol, i, c[col], s[col], gg[col], breakdown, dt)
            if brk:                         # the reference discards column i
                inner[col] = False
                continue
            H[col, :, i] = hcol
            c[col, i], s[col, i] = ci, si
            kk[col], gs_norm[col] = i + 1, abs(gg[col, i + 1])
            if gs_norm[col] <= gstol[col]:
                inner[col] = False
    return V, H, gg, kk, itr, gs_norm


def _gmres_batched(A, B, X0, M, opts, right, dot, cgs2=False):
    """``_gmres`` on every column of an (n, k) block, each column on its
    own single-rhs trajectory: the restart cycles run for every column
    still above its tolerance, a column's own count and gstol steer its
    inner loop, and a finished column keeps its X."""
    m, maxit = opts.restart, opts.maxit
    op, pc, X, RG = init_state(A, B, X0, M)
    dt = host_dtype(B.dtype).type
    tiny = np.finfo(dt).tiny
    k = B.shape[1]
    bnorm, beta0 = to_host(norm(B, dot), norm(RG, dot))
    tol = np.array([stopping_tol(b0, bn, opts) for b0, bn in zip(beta0, bnorm)], dt)
    rtol = tol / np.maximum(beta0.astype(dt), tiny)
    hist = history_init_block(opts, k, beta0)
    itr = np.zeros(k, np.int64)
    beta = beta0.astype(dt)
    gstol = np.zeros(k, dt)
    while True:
        live = (itr < maxit) & (beta > tol)
        if not live.any():
            break
        if right:
            bp_t = norm(RG, dot)
            V0 = RG / nonzero(bp_t)
        else:
            Z0 = pc(RG)
            bp_t = norm(Z0, dot)
            V0 = Z0 / nonzero(bp_t)
        bp = bp_t.cpu().to(torch.float64).numpy().astype(dt)
        if not right:                       # a column's first cycle seeds its gstol
            seed = live & (itr == 0)
            gstol[seed] = rtol[seed] * bp[seed] * dt(0.5)
        V, H, gg, kk, itr_new, gs_norm = _arnoldi_cycle_batched(
            op, pc, V0, bp, m, maxit, itr, tol if right else gstol, right,
            opts.breakdown, live, dot, cgs2)
        ym = np.stack([_solve_ym(H[c], gg[c], kk[c], m) if live[c] else np.zeros(m, dt)
                       for c in range(k)])
        ym_t = torch.from_numpy(ym).to(V.device, V.dtype)
        vy = torch.zeros_like(X)
        for j in range(int(kk.max())):
            vy = vy + ym_t[:, j] * V[j]
        live_t = torch.from_numpy(live).to(V.device)
        if right:
            X = torch.where(live_t, X + pc(vy), X)
            beta = np.where(live, gs_norm, beta)    # the Givens estimate is the residual
            RG = B - op(X)
        else:
            X = torch.where(live_t, X + vy, X)
            RG = B - op(X)
            res = norm(RG, dot).cpu().to(torch.float64).numpy().astype(dt)    # true residual each restart
            beta = np.where(live, res, beta)
            safe = np.maximum(beta / np.maximum(beta0.astype(dt), tiny), tiny)
            gstol = np.where(live, rtol * gs_norm / safe * dt(0.5), gstol)
        itr = itr_new
        history_update_block(opts, hist, itr, beta, cols=live)
    return X, SolveInfo(nits=itr, residual=beta.astype(np.float64), converged=beta <= tol,
                        r0norm=beta0, bnorm=bnorm, history=hist)


@register_batched("gmres")
def gmres_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """Left-preconditioned GMRES(m) on every column of an (n, k) block (the
    per-column path of ``solve_multi``)."""
    return _gmres_batched(A, B, X0, M, opts, right=False, dot=dot)


@register_batched("rgmres")
def gmres_r_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """Right-preconditioned GMRES(m) on every column of an (n, k) block."""
    return _gmres_batched(A, B, X0, M, opts, right=True, dot=dot)


@register_batched("cagmres")
def cagmres_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """cagmres (CGS2, left-preconditioned) on every column of an (n, k) block."""
    return _gmres_batched(A, B, X0, M, opts, right=False, dot=dot, cgs2=True)


@register_batched("cargmres")
def cargmres_batched(A, B, X0=None, M=None, opts=None, dot=base_dot):
    """cargmres (CGS2, right-preconditioned) on every column of an (n, k) block."""
    return _gmres_batched(A, B, X0, M, opts, right=True, dot=dot, cgs2=True)
