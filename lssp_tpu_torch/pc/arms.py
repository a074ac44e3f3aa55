"""ARMS-style multilevel recursive-Schur preconditioner.

The port of ``lssp_tpu/pc/arms.py`` (capability parity with the
reference's ITSOL ARMS adapter, pc-arms.cxx:83-153: ``arms2`` setup +
``armsol2`` apply), an independent-set elimination of the ILUM family.

Setup (host, per level, the same numpy as JAX's, so the splits and level
matrices come out bit for bit as JAX's):
  1. a greedy *independent set* F among diagonally-dominant rows (no F–F
     edges in the symmetrized pattern, so B = A[F,F] is DIAGONAL);
  2. the split A = [B F; E C] and the dropped Schur complement
     S ≈ C − E·B⁻¹·F (entries below ``tol``·row-mean dropped, the ILUT
     rule at pc-ilut.cxx:116-122);
  3. recursion on S; the coarsest level is factored exactly by the sparse
     direct LU (``pc/lu_host.py``, RCM ordering, JAX's choice).

Apply (device), for r (n,) or an (n, k) block:
     y_f = B⁻¹ r_f                (elementwise)
     z_c = M_S⁻¹ (r_c − E y_f)    (recursive)
     z_f = B⁻¹ (r_f − F z_c)      (ELL gathers + elementwise)
and at the bottom the exact coarse LU on the level schedule of
``ops/trisolve.py`` (the compact layout where JAX's padding would explode:
the RCM-ordered coarse factor of a convection-diffusion matrix is a
near-sequential chain of about as many levels as rows).  No kernel: the
levels are XLA gathers in JAX, plain torch here.  As in JAX no M⁻ᵀ is
installed.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.config import Defaults
from lssp_tpu_torch.pc.base import Preconditioner, register_pc
from lssp_tpu_torch.sparse.types import CSR


def _greedy_dd_mis(A: CSR):
    """Greedy independent set, visiting rows by diagonal dominance
    (most-dominant first) so the eliminated block is well-conditioned.
    Independence is with respect to the SYMMETRIZED pattern |A|+|A|ᵀ, so
    B = A[F,F] is guaranteed diagonal for nonsymmetric matrices too."""
    n = A.shape[0]
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.abs(np.asarray(A.data, dtype=np.float64))
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    diag = np.zeros(n)
    on = rows == idx
    diag[rows[on]] = dat[on]
    rowsum = np.bincount(rows, weights=dat, minlength=n) - diag
    dominance = diag / np.maximum(rowsum, 1e-300)
    # symmetrized adjacency for the independence test
    import scipy.sparse as sp
    G0 = sp.csr_matrix((np.ones_like(dat), idx, ip), shape=A.shape)
    G = (G0 + G0.T).tocsr()
    gp, gi = G.indptr.astype(np.int64), G.indices.astype(np.int64)
    # Parallel priority rounds (Luby-style) instead of the former sequential
    # greedy visit: each round every free vertex whose priority beats all
    # its free neighbours joins F and blocks them — vectorized numpy, a few
    # rounds total vs O(n) interpreter steps (config-#5 setup path).
    # Priority = dominance with a seeded-random tie break (pure index tie
    # break degenerates to O(n) rounds on constant-dominance chains).
    tie = np.random.default_rng(0).random(n)
    rank = np.empty(n, dtype=np.int64)
    rank[np.lexsort((tie, -dominance))] = np.arange(n)
    prio = -rank                                 # higher = earlier pick
    rowsG = np.repeat(np.arange(n, dtype=np.int64), np.diff(gp))
    self_edge = rowsG == gi
    state = np.zeros(n, dtype=np.int8)          # 0 free, 1 in F, 2 blocked
    while True:
        free_edge = ((state[rowsG] == 0) & (state[gi] == 0) & ~self_edge)
        nbmax = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
        np.maximum.at(nbmax, rowsG[free_edge], prio[gi[free_edge]])
        winners = (state == 0) & (prio > nbmax)
        if not winners.any():
            break
        state[winners] = 1
        blocked = free_edge & winners[rowsG]
        state[gi[blocked]] = np.maximum(state[gi[blocked]], 2)
    f_idx = np.flatnonzero(state == 1)
    c_idx = np.flatnonzero(state != 1)
    return f_idx, c_idx


def _drop(S, tol):
    """ILUT-style drop: |s_ij| < tol · (mean |row|) removed; diagonal kept."""
    S = S.tocsr()
    S.sum_duplicates()
    ip = S.indptr
    nrow = len(ip) - 1
    rows = np.repeat(np.arange(nrow), ip[1:] - ip[:-1])
    absd = np.abs(S.data)
    cnt = np.maximum(ip[1:] - ip[:-1], 1)
    rmean = np.bincount(rows, weights=absd, minlength=nrow) / cnt
    keep = (absd >= tol * rmean[rows]) | (rows == S.indices)
    import scipy.sparse as sp
    return sp.csr_matrix((S.data[keep], (rows[keep], S.indices[keep])),
                         shape=S.shape)


def _safe_inv(d):
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    d = np.where(small, np.where(d >= 0, Defaults.ZERO_DIAG_VALUE,
                                 -Defaults.ZERO_DIAG_VALUE), d)
    return 1.0 / d


def arms_setup(A: CSR, tol: float = 1e-3, max_levels: int = 10, coarse_size: int = 200,
               device="cpu"):
    """The per-level state list and the coarsest LU's apply state, on
    ``device`` in A's dtype: (levels, coarse), each level (f_idx, c_idx,
    invd, E, F) with E and F as ELL."""
    import scipy.sparse as sp
    from lssp_tpu_torch.pc.lu import lu_state
    from lssp_tpu_torch.pc.lu_host import splu_factor
    from lssp_tpu_torch.sparse.convert import csr_to_ell

    dtype = np.asarray(A.data).dtype
    levels = []
    S = A.to_scipy().tocsr()
    for _ in range(max_levels):
        n = S.shape[0]
        if n <= coarse_size:
            break
        cur = CSR.from_scipy(S)
        f_idx, c_idx = _greedy_dd_mis(cur)
        # degenerate split: stop coarsening
        if len(f_idx) < max(8, n // 16) or len(c_idx) == 0:
            break
        B_diag = np.asarray(S[f_idx, f_idx]).ravel()
        invd = _safe_inv(B_diag).astype(dtype)
        E = S[c_idx][:, f_idx].tocsr()
        F = S[f_idx][:, c_idx].tocsr()
        C = S[c_idx][:, c_idx].tocsr()
        Snew = _drop(C - E @ sp.diags(invd) @ F, tol)
        levels.append((
            torch.from_numpy(f_idx).to(device), torch.from_numpy(c_idx).to(device),
            torch.from_numpy(invd).to(device),
            csr_to_ell(CSR.from_scipy(E.astype(dtype)), device=device),
            csr_to_ell(CSR.from_scipy(F.astype(dtype)), device=device),
        ))
        S = Snew
    # coarsest: the exact sparse LU
    f = splu_factor(CSR.from_scipy(S.astype(np.float64)).astype(dtype), order="rcm")
    return levels, lu_state(f, dtype, device)


def _arms_apply(state, r):
    from lssp_tpu_torch.ops.spmv import spmv
    from lssp_tpu_torch.pc.lu import _lu_apply
    levels, coarse = state

    def rec(lev, rr):
        if lev == len(levels):
            return _lu_apply(coarse, rr)
        f_idx, c_idx, invd, E, F = levels[lev]
        if rr.dim() == 2:
            invd = invd[:, None]
        r_f = rr[f_idx]
        y_f = invd * r_f
        z_c = rec(lev + 1, rr[c_idx] - spmv(E, y_f))
        z_f = invd * (r_f - spmv(F, z_c))
        z = torch.empty_like(rr)
        z[f_idx] = z_f
        z[c_idx] = z_c
        return z

    return rec(0, r)


@register_pc("arms")
def setup_arms(A, opts, device):
    state = arms_setup(A, tol=opts.arms_tol, max_levels=opts.arms_max_levels,
                       coarse_size=opts.arms_coarse_size, device=device)
    return Preconditioner(_arms_apply, state=state, name="arms")
