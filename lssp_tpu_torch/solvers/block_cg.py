"""Block Conjugate Gradient for multiple right-hand sides (O'Leary 1980),
the port of ``lssp_tpu/solvers/block_cg.py``.

All k right-hand sides share one Krylov search block: the matrix and the
preconditioner stream once per iteration for the whole block (kernels
K1k-K4k), information mixes across the columns, and every reduction is a
k×k Gram.  Preconditioned block CG (SPD A, SPD M):

    Z = M⁻¹R,  P = Z
    repeat:  Q = A P
             α = (PᵀQ)⁻¹ (ZᵀR)        (k×k solves)
             X += P α;  R -= Q α
             Z = M⁻¹R
             β = (ZᵀR)_old⁻¹ (ZᵀR)_new
             P = Z + P β

Breakdown defences, as in JAX: a relative O(eps) ridge on the k×k solves
(duplicate columns then converge in lock-step), residual replacement every
32 iterations, at apparent convergence and on breakdown (the loop only
exits on a recomputed residual), restart of the conjugacy on breakdown,
and an honest unconverged exit on two breakdowns in a row.

The Grams and the (n, k)·(k, k) combines are ``torch.matmul``: JAX writes
them as mul+sum only because an fp64 dot is lossy on a TPU.  Every Gram
and column norm² goes through ``reduce`` (JAX's ``reduce=``): the
identity on one device, the sum over the ranks of a distributed solve,
one reduction of a k×k (or (k,)) partial per reduction point.  The k×k
solves stay on the device (``solve_ex``, no sync); each iteration brings
the k recursive residual norms and the breakdown flag to the host once
to decide the residual replacement, plus one more read on the iterations
that replace it.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, history_init_block, history_update_block, init_state, reduced_grams, ridge,
    to_host,
)


def block_cg(A, B, X0=None, M=None, opts=None, reduce=None):
    """Solve A X = B for all columns of B (n, k) at once.

    Returns (X (n, k), SolveInfo with per-column (k,) nits / residual /
    converged).  The stopping rule is ``cg``'s per column; the loop runs
    until every column meets its tolerance (or maxit, or two breakdowns).
    Every Gram and norm is ``chunked_gram`` over the rows held here, then
    ``reduce`` (None: the identity; the distributed launcher passes the
    sum over the ranks)."""
    gram, gram_norms = reduced_grams(reduce)
    op, pc, X, R = init_state(A, B, X0, M)
    n, k = B.shape
    bnorm, r0norm = to_host(gram_norms(B), gram_norms(R))
    tol = np.maximum(np.maximum(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)
    hist = history_init_block(opts, k, r0norm)

    it, res = 0, r0norm
    nits = np.where(r0norm <= tol, 0, opts.maxit)
    P = torch.zeros_like(B)
    rho_old = torch.eye(k, dtype=B.dtype, device=B.device)
    fresh, done = True, False
    while it < opts.maxit and not done and (res > tol).any():
        Z = pc(R)
        rho = gram(Z, R)                                    # (k, k)
        if not fresh:
            P = Z + P @ torch.linalg.solve_ex(ridge(rho_old), rho)[0]
        else:
            P = Z
        Q = op(P)
        alpha = torch.linalg.solve_ex(ridge(gram(P, Q)), rho)[0]
        Xn = X + P @ alpha
        Rn = R - Q @ alpha
        rec_t = gram_norms(Rn)
        ok_t = torch.isfinite(alpha).all() & torch.isfinite(rec_t).all()
        rec, ok = to_host(rec_t, ok_t.expand(k))
        okstep = bool(ok[0])
        if okstep:
            X = Xn
        # residual replacement at apparent convergence, every 32 its and on
        # breakdown; the conjugacy restarts on breakdown only
        if not okstep or (rec <= tol).all() or it % 32 == 31:
            R = B - op(X)
            (res_new,) = to_host(gram_norms(R))
        else:
            R, res_new = Rn, rec
        nits = np.where((res > tol) & (res_new <= tol), it + 1, nits)
        history_update_block(opts, hist, it + 1, res_new, r0norm, bnorm)
        if not okstep:
            P = torch.zeros_like(P)                         # NaN-free restart
        rho_old = rho
        done = not okstep and fresh
        fresh = not okstep
        it, res = it + 1, res_new
    # the report rests on a recomputed residual: a maxit or breakdown exit
    # can leave res on a recursive one up to 31 steps stale
    (res,) = to_host(gram_norms(B - op(X)))
    nits = np.where(res <= tol, np.minimum(nits, it), it)
    if hist is not None:
        hist[:, min(it, opts.maxit)] = res
    return X, SolveInfo(nits=nits, residual=res, converged=res <= tol, r0norm=r0norm,
                        bnorm=bnorm, history=hist)
