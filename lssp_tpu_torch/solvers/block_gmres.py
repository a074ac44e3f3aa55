"""Restarted block GMRES for multiple right-hand sides (Vital 1990), the
port of ``lssp_tpu/solvers/block_gmres.py``.

All k right-hand sides share one block-Krylov basis: the matrix and the
preconditioner stream once per block-Arnoldi step for the whole block
(kernels K1k-K4k), and every orthogonalisation is a stacked Gram.
Right-preconditioned, one restart cycle (m = opts.restart):

    R = B − A·X;  (V₀, S₀) = qr(R)                      (CholQR², k×k)
    for j < m:   W = A M⁻¹ V_j
                 Hᵢⱼ = VᵢᵀW (all i at once, CGS2);  W −= Σ Vᵢ Hᵢⱼ
                 (V_{j+1}, H_{j+1,j}) = qr(W)           (CholQR², ridge)
    Y = argmin ‖E₁S₀ − H̄Y‖_F   (dense QR of the small H̄, per cycle)
    X += M⁻¹(V·Y);  R = B − A·X  → exit on the true residual per column

As in JAX: CholQR² with the relative ridge (plus an absolute floor, so a
vanished block factors to tiny values, not NaN), block CGS2, the basis
carried as (n, m+1, k) so the stacked (n, (j+1)·k) view is free,
step-granular ``nits`` from the one QR's prefix residual estimates, and
an exit after three cycles that leave every active column's residual
bit-stationary.  The Grams and combines are ``torch.matmul`` on the
device; the (m+1)k × mk least squares runs once per cycle on the host in
numpy, in the solve's dtype (two host reads a cycle: H̄, and the
recomputed residuals).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, history_init_block, history_update_block, init_state, reduced_grams, ridge,
    to_host,
)
from lssp_tpu_torch.sparse.types import numpy_dtype


def _cholqr2(W, floor, gram):
    """Two-pass Cholesky QR: W = V·S with V near-orthonormal, S upper k×k;
    the ridge keeps the Gram factorable when the block lost rank."""
    def one(W):
        L = torch.linalg.cholesky_ex(ridge(gram(W, W), floor))[0]
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return W @ Linv.mT, L.mT                       # V = W L⁻ᵀ
    V1, S1 = one(W)
    V2, S2 = one(V1)
    return V2, S2 @ S1


def _least_squares(Hbar, S0, m, k, dt):
    """Y = argmin ‖E₁S₀ − H̄Y‖_F by one dense QR, and the per-step residual
    estimates est (m, k): est[j−1, c] is column c's LS residual after j
    block steps, from the suffix sums of (Qᵀg)² plus the explicitly formed
    complement ‖(I − QQᵀ)g‖² (no ‖g‖² − cumsum cancellation)."""
    g = np.zeros(((m + 1) * k, k), dt)
    g[:k] = S0
    Q, Rt = np.linalg.qr(Hbar, mode="reduced")
    d = np.diagonal(Rt)
    Rt = Rt + np.diag(np.where(d == 0.0, 1.0, 0.0).astype(dt))
    Qtg = Q.T @ g
    Y = scipy.linalg.solve_triangular(Rt, Qtg, lower=False)
    tail = g - Q @ Qtg
    tail2 = np.sum(tail * tail, axis=0)
    suffix = np.flip(np.cumsum(np.flip(Qtg * Qtg, 0), axis=0), 0)       # (mk, k)
    suffix_at = np.concatenate([suffix[k::k, :], np.zeros((1, k), dt)], axis=0)
    return Y.astype(dt), np.sqrt(tail2[None, :] + suffix_at)


def block_gmres(A, B, X0=None, M=None, opts=None, reduce=None):
    """Solve A X = B for all columns of B (n, k) at once: restarted,
    right-preconditioned block GMRES.

    Returns (X (n, k), SolveInfo with per-column (k,) nits / residual /
    converged).  ``nits`` is step-granular: in the cycle whose recomputed
    residual confirms a column converged, the prefix estimates locate the
    block-Arnoldi step it crossed its tolerance at.  The loop runs until
    every column meets its tolerance, maxit block steps elapse, or three
    cycles in a row leave every active column's residual bit-stationary.
    Basis memory is (m+1)·n·k.  ``reduce``: as in ``block_cg``, applied to
    every Gram and column norm² (JAX's ``reduce=``)."""
    gram, gram_norms = reduced_grams(reduce)
    op, pc, X, R = init_state(A, B, X0, M)
    n, k = B.shape
    m = max(1, min(int(opts.restart), int(opts.maxit)))
    dtype = B.dtype
    dt = numpy_dtype(dtype).type
    eps = float(np.finfo(dt).eps)
    floor = float(np.sqrt(np.finfo(dt).tiny))       # stays normal after ·eps
    bnorm, r0norm = to_host(gram_norms(B), gram_norms(R))
    tol = np.maximum(np.maximum(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)

    def cycle(X, R):
        V0, S0 = _cholqr2(R, floor, gram)
        V = B.new_zeros((n, m + 1, k))
        V[:, 0] = V0
        H = B.new_zeros((m, m + 1, k, k))
        Vj = V0
        for j in range(m):
            W = op(pc(Vj))
            Vflat = V[:, :j + 1].reshape(n, (j + 1) * k)   # a view: the basis so far
            h1 = gram(Vflat, W)                            # block CGS2
            W = W - Vflat @ h1
            h2 = gram(Vflat, W)
            W = W - Vflat @ h2
            Vj, Sj = _cholqr2(W, floor, gram)
            V[:, j + 1] = Vj
            H[j, :j + 1] = (h1 + h2).view(j + 1, k, k)
            H[j, j + 1] = Sj
        # H̄[(i), (j)] = H[j, i]: the (m+1)k × mk block Hessenberg matrix
        Hbar = H.permute(1, 2, 0, 3).reshape((m + 1) * k, m * k)
        Y, est = _least_squares(Hbar.cpu().numpy(), S0.cpu().numpy(), m, k, dt)
        C = V[:, :m].reshape(n, m * k) @ torch.from_numpy(Y).to(B.device)
        Xn = X + pc(C)
        Rn = B - op(Xn)
        return Xn, Rn, est, gram_norms(Rn)

    # each cycle writes its m per-step estimates, then the recomputed
    # end-of-cycle residual over the last one; ``extra=m`` lets the last
    # cycle write past maxit, sliced back below
    hist = history_init_block(opts, k, r0norm, extra=m)
    it, res, stall, done = 0, r0norm, 0, False
    nits = np.where(r0norm <= tol, 0, opts.maxit)
    while it < opts.maxit and not done and (res > tol).any():
        Xn, Rn, est, res_t = cycle(X, R)
        (res_new,) = to_host(res_t)
        ok = bool(np.isfinite(res_new).all())     # NaN/Inf in X surfaces in Rn
        if ok:
            X, R = Xn, Rn
        else:
            res_new = res
        # progress: an active column shrank at all, or crossed its tolerance
        active = res > tol
        improved = ok and bool((active & ((res_new < res * (1.0 - 16.0 * eps))
                                          | (res_new <= tol))).any())
        stall = 0 if improved else stall + 1
        hit = est <= tol[None, :]                                   # (m, k)
        jstar = np.where(hit.any(axis=0), hit.argmax(axis=0) + 1, m)
        nits = np.where(active & (res_new <= tol), it + jstar, nits)
        if hist is not None:
            hist[:, it + 1:it + 1 + m] = est.T if ok else np.nan
        history_update_block(opts, hist, it + m, res_new, r0norm, bnorm)
        it, res = it + m, res_new
        done = not ok or stall >= 3
    nits = np.minimum(np.minimum(nits, it), opts.maxit)     # it steps past maxit by m
    if hist is not None:
        hist = hist[:, :opts.maxit + 1]
    return X, SolveInfo(nits=nits, residual=res, converged=res <= tol, r0norm=r0norm,
                        bnorm=bnorm, history=hist)
