"""Classical AMG setup (host-side, numpy/scipy): strength-of-connection →
PMIS coarsening → direct interpolation → Galerkin RAP.

A copy of ``lssp_tpu/amg/setup.py`` (the JAX package's host setup, which
imports no JAX itself but sits in a package that does), so the port's
hierarchies are identical to it: the same seeded numpy generators, the same
native Gershgorin bound (``native/src/rap.cpp``) under the same condition.
PMIS coarsening and Jacobi/Chebyshev smoothers keep every device operation
pointwise or an SpMV.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from lssp_tpu_torch.sparse.types import CSR


def strength_graph(A: sp.csr_matrix, theta: float = 0.25) -> sp.csr_matrix:
    """Classical Ruge–Stüben strength: j strongly influences i iff
    ``-a_ij >= theta * max_{k != i}(-a_ik)`` (M-matrix convention).
    Returns a boolean CSR (no diagonal)."""
    A = A.tocsr()
    n = A.shape[0]
    D = A.diagonal()
    off = A - sp.diags(D)
    off = off.tocsr()
    neg = -off.toarray() if n <= 2000 else None
    if neg is not None:
        thresh = theta * neg.max(axis=1, initial=0.0)
        S = (neg >= thresh[:, None]) & (neg > 0)
        return sp.csr_matrix(S)
    # sparse path — vectorized row max (a Python per-row loop costs minutes
    # of interpreter time at 1M rows; ufunc.at is C-speed)
    indptr, indices, data = off.indptr, off.indices, -off.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, data)
    rowmax = np.maximum(rowmax, 0.0)
    keep = (data >= theta * rowmax[rows]) & (data > 0)
    return sp.csr_matrix(
        (np.ones(keep.sum()), indices[keep],
         np.concatenate([[0], np.cumsum(np.bincount(rows[keep], minlength=n))])),
        shape=A.shape)


def pmis_coarsen(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS: parallel maximal independent set coarsening.

    Returns state array: +1 C-point, -1 F-point.  Deterministic via seeded
    tie-break randomness.  F-points left without a strong C neighbour are
    flipped to C afterwards (direct interpolation needs one).
    """
    n = S.shape[0]
    G = ((S + S.T) > 0).tocsr()            # symmetrized strength graph
    gi = np.repeat(np.arange(n), np.diff(G.indptr))
    gj = G.indices
    rng = np.random.default_rng(seed)
    w = np.asarray(S.sum(axis=0)).ravel() + rng.random(n)   # |S^T_i| + rand
    state = np.zeros(n, dtype=np.int8)
    undecided = state == 0
    while undecided.any():
        # candidate C: weight strictly greater than every undecided neighbour
        is_max = undecided.copy()
        mask = undecided[gi] & undecided[gj]
        lose = gi[mask][w[gi[mask]] <= w[gj[mask]]]
        is_max[lose] = False
        if not is_max.any():
            # numerical tie pathologies: promote the max-weight undecided
            is_max[np.argmax(np.where(undecided, w, -np.inf))] = True
        state[is_max] = 1
        # undecided strongly connected to a new C become F
        touch = is_max[gi]
        nbrs = gj[touch]
        state[nbrs[state[nbrs] == 0]] = -1
        undecided = state == 0
    # ensure every F point has a strong C neighbour (direct interp needs one)
    Sc = S.tocsr()
    si = np.repeat(np.arange(n), np.diff(Sc.indptr))
    has_c = np.zeros(n, dtype=bool)
    hit = state[Sc.indices] == 1
    has_c[np.unique(si[hit])] = True
    state[(state == -1) & ~has_c] = 1
    return state


def direct_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                         state: np.ndarray) -> sp.csr_matrix:
    """Classical direct interpolation (Stüben), fully vectorized:
    F-point i: w_ij = -α_i a_ij / a_ii over strong C neighbours j, with
    α_i = Σ_{k≠i} a_ik / Σ_{j∈C∩S_i} a_ij;  C-point: identity."""
    n = A.shape[0]
    cpts = np.nonzero(state == 1)[0]
    cmap = -np.ones(n, dtype=np.int64)
    cmap[cpts] = np.arange(len(cpts))
    Ad = A.tocsr()
    diag = Ad.diagonal()
    # entries of A restricted to the strong-C pattern: mask S's columns by
    # C membership, then Hadamard with A
    is_c_col = (state == 1)
    Sd = S.tocsr()
    rows_s = np.repeat(np.arange(n), np.diff(Sd.indptr))
    keepsc = is_c_col[Sd.indices]
    # strong-C pattern as boolean CSR — built by masking the row-ordered
    # arrays directly (the COO constructor re-sorts ~50M entries at the
    # 16.8M scale)
    sc_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_s[keepsc], minlength=n), out=sc_indptr[1:])
    SCpat = sp.csr_matrix((np.ones(int(keepsc.sum())),
                           Sd.indices[keepsc], sc_indptr), shape=(n, n))
    ASC = Ad.multiply(SCpat).tocsr()          # a_ij over j ∈ C∩S_i
    den = np.asarray(ASC.sum(axis=1)).ravel()
    num = np.asarray(Ad.sum(axis=1)).ravel() - diag
    dii = np.where(diag != 0, diag, 1.0)
    valid_f = (state == -1) & (den != 0) & (np.diff(ASC.indptr) > 0)
    alpha = np.zeros(n)
    alpha[valid_f] = num[valid_f] / den[valid_f]
    scale = -alpha / dii                      # per-row scale for F rows
    rows_a = np.repeat(np.arange(n), np.diff(ASC.indptr))
    keep = valid_f[rows_a]
    r = rows_a[keep]
    c = cmap[ASC.indices[keep]]
    v = scale[r] * ASC.data[keep]
    # C rows: identity
    r = np.concatenate([r, cpts])
    c = np.concatenate([c, cmap[cpts]])
    v = np.concatenate([v, np.ones(len(cpts))])
    return sp.csr_matrix((v, (r, c)), shape=(n, len(cpts)))


@dataclasses.dataclass
class AMGLevel:
    A: sp.csr_matrix
    P: Optional[sp.csr_matrix]     # None on the coarsest level
    dinv: np.ndarray               # 1 / diag(A)
    lmax: float                    # estimate of λ_max(D⁻¹A) for Chebyshev


@dataclasses.dataclass
class AMGHierarchy:
    levels: List[AMGLevel]
    coarse_inv: np.ndarray         # dense inverse of the coarsest A

    @property
    def nlevels(self):
        return len(self.levels) + 1

    def complexity(self):
        """Operator complexity Σ nnz(A_l) / nnz(A_0)."""
        total = sum(l.A.nnz for l in self.levels) + self.coarse_inv.size
        return total / self.levels[0].A.nnz


def _lambda_max(A: sp.csr_matrix, dinv: np.ndarray, iters: int = 15,
                seed: int = 0) -> float:
    """Power iteration estimate of λ_max(D⁻¹A).

    Runs in fp32: the estimate feeds a Chebyshev interval with a 1.1
    safety factor (and ω_p/λ prolongator damping), where 1e-3 accuracy is
    ample — and fp32 matvecs halve the memory traffic of what is a pure
    bandwidth-bound loop (measured ~15 s of the 16.8M saamg setup in
    fp64)."""
    A32 = A if A.dtype == np.float32 else A.astype(np.float32)
    d32 = dinv.astype(np.float32, copy=False)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0]).astype(np.float32)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = d32 * (A32 @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def lambda_gershgorin(A: sp.csr_matrix, dinv: np.ndarray) -> float:
    """Row-sum (Gershgorin) upper bound on λ_max(D⁻¹A): max_i dinv_i·Σ_j
    |a_ij|.  One O(nnz) pass — no matvecs, no fp32 copies."""
    A = A.tocsr()
    from lssp_tpu_torch import native
    if native.available():
        val = native.gersh(A.indptr, A.data, dinv, A.shape[0])
        if val is not None:
            return val if val > 0 else 1.0
    absd = np.abs(A.data)
    nnz_row = np.diff(A.indptr)
    rs = np.zeros(A.shape[0])
    nz = nnz_row > 0
    if nz.any():
        rs[nz] = np.add.reduceat(absd, A.indptr[:-1][nz])
    val = float((rs * np.abs(dinv)).max()) if A.shape[0] else 1.0
    return val if val > 0 else 1.0


_LMAX_GERSHGORIN_ABOVE = 2_000_000


def lambda_est(A: sp.csr_matrix, dinv: np.ndarray) -> float:
    """λ_max(D⁻¹A) estimate for smoother intervals: power iteration on
    small levels, Gershgorin above ``_LMAX_GERSHGORIN_ABOVE`` rows.  The
    bound is tight exactly where it is used (measured 1.02-1.06× power-15
    on the fine stencil levels of the shipped matrix classes; the loose
    1.4-1.6× cases are small coarse levels, which keep power iteration) —
    and the 15-matvec fp32 power loop was 22 s of the 16.8M saamg setup."""
    if A.shape[0] > _LMAX_GERSHGORIN_ABOVE:
        return lambda_gershgorin(A, dinv)
    return _lambda_max(A, dinv)


def truncate_P(P: sp.csr_matrix, eps: float) -> sp.csr_matrix:
    """Drop interpolation weights |w| < eps·max|row| and rescale each row to
    preserve its sum (keeps constants interpolated exactly) — the standard
    complexity-control for smoothed interpolation.  Vectorized."""
    P = P.tocsr()
    n = P.shape[0]
    rows = np.repeat(np.arange(n), np.diff(P.indptr))
    absd = np.abs(P.data)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, absd)
    rowsum = np.asarray(P.sum(axis=1)).ravel()
    keep = absd >= eps * rowmax[rows]
    r, c, v = rows[keep], P.indices[keep], P.data[keep]
    newsum = np.zeros(n)
    np.add.at(newsum, r, v)
    scale = np.where((newsum != 0) & (rowsum != 0),
                     rowsum / np.where(newsum == 0, 1.0, newsum), 1.0)
    return sp.csr_matrix((v * scale[r], (r, c)), shape=P.shape)


def amg_setup(A: CSR, theta: float = 0.25, max_levels: int = 12,
              coarse_size: int = 64, seed: int = 0,
              smooth_interp: bool = True, interp_omega: float = 2.0 / 3.0,
              trunc: float = 0.2) -> AMGHierarchy:
    """Build the multilevel hierarchy: strength → PMIS → direct interp →
    (optional) Jacobi-smoothed + truncated P → Galerkin RAP (scipy SpGEMM),
    until the coarse grid is small enough.

    Measured V-cycle convergence factors with the defaults (Jacobi(2, 2/3)
    smoothing): 0.29 on Poisson 64², 0.31 on 128² (grid-size robust), 0.23
    on anisotropic (ε=1e-3), 0.26 on 3-D 16³, operator complexity ≈ 2.3-2.6.
    Plain direct interpolation (smooth_interp=False) gives cf ≈ 0.68 at
    complexity 1.9 — available when setup cost/memory dominates.
    """
    Al = A.to_scipy().tocsr().astype(np.float64)
    levels: List[AMGLevel] = []
    for _ in range(max_levels):
        n = Al.shape[0]
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        if n <= coarse_size:
            break
        S = strength_graph(Al, theta)
        state = pmis_coarsen(S, seed=seed)
        nc = int((state == 1).sum())
        if nc == 0 or nc >= n:
            break                           # coarsening stalled
        P = direct_interpolation(Al, S, state)
        if smooth_interp:
            # one weighted-Jacobi smoothing pass on P (smoothed-aggregation
            # trick applied to the classical P), then truncation
            P = ((sp.eye(n) - interp_omega * sp.diags(dinv) @ Al) @ P).tocsr()
            if trunc:
                P = truncate_P(P, trunc)
        levels.append(AMGLevel(A=Al, P=P, dinv=dinv,
                               lmax=_lambda_max(Al, dinv)))
        Al = (P.T @ Al @ P).tocsr()         # Galerkin RAP
        Al.sort_indices()
    d = Al.diagonal().copy()
    d[d == 0] = 1.0
    levels.append(AMGLevel(A=Al, P=None, dinv=1.0 / d,
                           lmax=_lambda_max(Al, 1.0 / d)))
    coarse_inv = np.linalg.pinv(Al.toarray())
    return AMGHierarchy(levels=levels, coarse_inv=coarse_inv)
