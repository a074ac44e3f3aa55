"""LGMRES(m, k), left- and right-preconditioned (reference lssp_solver_lgmres
/ lssp_solver_lgmres_r, solver-lgmres.cxx:12-311 and :313-604).

"Loose" GMRES: the Krylov basis is augmented with the last k = ``aug_k``
outer corrections z (a ring).  Arnoldi column i ≥ m multiplies A against
z[i − m] in place of v[i] (:158-164); the basis grows to m +
min(outer cycle, k) columns (:128-134).  After each cycle the correction
Δx goes into the ring (:225-256).  At the solve label kk = i (:205): the
current column is discarded when the cycle stops on its tolerance, and
the one before it too on a breakdown, as in the reference.

One body for the single-rhs and the per-column batched form (``lanes``):
each Arnoldi step reads its Hessenberg column (every lane's) once, and
the Givens recurrence and the small triangular solve run on the host per
lane, in the solve's dtype.  ``arnoldi`` is the cycle shared with
``fgmres``.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.gmres import _givens_step, _solve_ym
from lssp_tpu_torch.solvers.lanes import Lanes, combine
from lssp_tpu_torch.solvers.registry import register_batched, register_solver
from lssp_tpu_torch.sparse.types import numpy_dtype


def arnoldi(column, v0, beta_p, m, itr, maxit, tol, breakdown, live, check_maxit, discard,
            dot):
    """One restart cycle of modified Gram–Schmidt Arnoldi with Givens
    rotations on every lane in ``live`` (a host mask of the lane shape).

    ``column(i, V)`` gives the new direction of column i from the basis V
    (m, n) + lane.  A lane leaves the cycle on its breakdown (the column
    is dropped), on |g[i+1]| ≤ its ``tol``, or, with ``check_maxit``, at
    ``maxit`` steps.  ``discard``: LGMRES's solve label (kk = i on a
    tolerance stop, max(i − 1, 0) on a breakdown); else GMRES's (column i
    kept on a stop).  ``dot``: the solve's inner product.  Returns (V,
    H (K, m+1, m), g (K, m+1), kk (K,), itr, |g[kk]| (K,)) with K lanes;
    ``itr`` and the estimates in the lane shape."""
    dt = numpy_dtype(v0.dtype).type
    shape = np.shape(live)
    K = int(np.prod(shape))
    V = v0.new_zeros((m,) + tuple(v0.shape))
    V[0] = v0
    H = np.zeros((K, m + 1, m), dt)
    gg = np.zeros((K, m + 1), dt)
    gg[:, 0] = np.reshape(beta_p, K)
    c = np.zeros((K, m), dt)
    s = np.zeros((K, m), dt)
    kk = np.zeros(K, np.int64)
    gs = np.full(K, np.inf, dt)
    tol = np.broadcast_to(np.asarray(tol, dt).reshape(-1), (K,))
    itr = np.array(itr, np.int64).reshape(K)
    inner = np.array(live, bool).reshape(K)
    for i in range(m):
        if check_maxit:
            inner &= itr < maxit
        if not inner.any():
            break
        itr += inner
        w = column(i, V)
        hs = []
        for j in range(i + 1):              # modified Gram–Schmidt
            hij = dot(w, V[j])
            w = w - hij * V[j]
            hs.append(hij)
        hnorm = norm(w, dot)
        hcols = torch.stack(hs + [hnorm]).cpu().numpy().reshape(i + 2, K)
        for lane in np.flatnonzero(inner):
            hcol = np.zeros(m + 1, dt)
            hcol[:i + 2] = hcols[:, lane]
            brk, ci, si = _givens_step(hcol, i, c[lane], s[lane], gg[lane], breakdown, dt)
            if brk:
                if discard:
                    kk[lane] = max(i - 1, 0)
                inner[lane] = False
                continue
            H[lane, :, i] = hcol
            c[lane, i], s[lane, i] = ci, si
            gs[lane] = abs(gg[lane, i + 1])
            stop = gs[lane] <= tol[lane]
            kk[lane] = i if discard and stop else i + 1
            inner[lane] &= ~stop
        if i + 1 < m and inner.any():       # a lane that left never reads it
            V[i + 1] = w / (hnorm if K == 1 else nonzero(hnorm))
    return V, H, gg, kk, itr.reshape(shape), gs.reshape(shape)


def solve_ym(H, gg, kk, m, shape, like):
    """Each lane's ym (``gmres._solve_ym``), as (m,) + lane on the device."""
    ym = np.stack([_solve_ym(H[j], gg[j], kk[j], m) for j in range(len(kk))], axis=-1)
    return torch.from_numpy(ym.reshape((m,) + shape)).to(like.device)


def _lgmres(A, b, x0, M, opts, right, dot):
    mk = opts.restart
    auk = max(opts.aug_k, 0)
    m_max = mk + auk
    op, pc, x, rg = init_state(A, b, x0, M)
    L = Lanes(b, rg, opts, dot=dot)
    dt = numpy_dtype(b.dtype).type
    tiny = np.finfo(dt).tiny
    tol = L.tol.astype(dt)
    rtol = tol / np.maximum(L.r0norm.astype(dt), tiny)
    gstol = np.zeros(L.shape, dt)
    Z = []
    outer = 0
    while L.active.any():
        live = L.active
        m_dyn = mk + min(outer, auk)
        v = rg if right else pc(rg)
        bp_t = norm(v, dot)
        v0 = v / nonzero(bp_t)
        (bp,) = L.read(bp_t)
        bp = bp.astype(dt)
        if not right and outer == 0:        # the first cycle seeds gstol
            gstol = rtol * bp * dt(0.5)

        def column(i, V):
            operand = V[i] if i < mk else Z[i - mk]
            return op(pc(operand)) if right else pc(op(operand))

        V, H, gg, kk, itr, gs = arnoldi(column, v0, bp, m_dyn, L.it, opts.maxit,
                                        tol if right else gstol, opts.breakdown, live,
                                        check_maxit=right, discard=True, dot=dot)
        ym = solve_ym(H, gg, kk, m_dyn, L.shape, b)
        nv = min(int(kk.max()), mk)
        corr = combine(ym[:nv], V[:nv])
        if int(kk.max()) > mk:
            corr = corr + combine(ym[mk:int(kk.max())], torch.stack(Z[:int(kk.max()) - mk]))
        if right:
            x = L.pick(live, x + pc(corr), x)
            beta = gs                       # the Givens estimate is the residual
            rg = b - op(x)
        else:
            x = L.pick(live, x + corr, x)
            rg = b - op(x)
            (beta,) = L.read(norm(rg, dot))
            beta = beta.astype(dt)
            safe = np.maximum(beta / np.maximum(L.r0norm.astype(dt), tiny), tiny)
            gstol = np.where(live, rtol * gs / safe * dt(0.5), gstol)
        if auk > 0:                         # the ring of the last aug_k corrections
            if len(Z) < auk:
                Z.append(corr)
            else:
                Z[outer % auk] = corr
        L.it = np.where(live, itr, L.it)
        L.res = np.where(live, beta, L.res)
        L.record(live)
        L.settle()
        outer += 1
    return L.result(x)


@register_batched("lgmres")
@register_solver("lgmres")
def lgmres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Left-preconditioned LGMRES(m, k) (reference LSSP_SOLVER_LGMRES)."""
    return _lgmres(A, b, x0, M, opts, right=False, dot=dot)


@register_batched("rlgmres")
@register_solver("rlgmres")
def lgmres_r(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """Right-preconditioned LGMRES(m, k) (reference LSSP_SOLVER_RLGMRES)."""
    return _lgmres(A, b, x0, M, opts, right=True, dot=dot)
