"""Supernodal multifrontal LU (host side) — the BLAS-3 direct-factorization
performance class.

The port of ``lssp_tpu/pc/multifrontal.py`` (the same symbolic phase, the
same numeric oracle, the same C++ engine ``native/src/mf.cpp``).  The
reference reaches dense-kernel factorization throughput through its
UMFPACK/MUMPS/SuperLU adapters (solver-umfpack.cxx:107-153,
solver-mumps.cxx:162-210, solver-superlu.cxx:28-85); the scalar
Gilbert–Peierls LU (``pc/lu_host.py``) stays an order-class behind on
factor time.  This module closes that gap natively:

* **Symbolic** (numpy): AMD ordering on the symmetrized pattern, Liu
  elimination tree, bottom-up column rowsets, fundamental-supernode
  merging (parent chain + count equality) with relaxed amalgamation of
  narrow children (bounded explicit-zero fill for fatter BLAS panels).
* **Numeric** (numpy/LAPACK): multifrontal traversal with an update
  stack.  Each supernode assembles a square dense front (its columns'
  A-entries plus children's Schur complements, extend-added by index
  mapping), factors the leading block with LAPACK partial pivoting
  RESTRICTED to the block rows (the MUMPS-style compromise — pivots
  never cross supernodes, near-zero pivots are clamped with the
  library-wide rule), forms L21/U12 by triangular solves and the Schur
  complement by one dgemm — all BLAS-3.
* The result is repackaged as the same ``SpLU`` container the scalar
  path produces (strict-lower L CSR + upper U CSR + row permutations),
  so the device-side level-scheduled triangular solves, the ``lu`` PC,
  ``method="direct"`` and ``solve_ir`` consume it unchanged.

Unsymmetric matrices factor on the symmetrized pattern (struct(A+Aᵀ)):
a superset of the true fill, the standard price for supernode reuse.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from lssp_tpu_torch.config import Defaults
from lssp_tpu_torch.sparse.types import CSR


# --------------------------------------------------------------------------
# symbolic
# --------------------------------------------------------------------------

def etree_sym(Mp, Mi, n) -> np.ndarray:
    """Liu's elimination-tree algorithm on a symmetric pattern (CSR arrays,
    both triangles).  Returns parent (n,), -1 at roots."""
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(Mp[j], Mp[j + 1]):
            i = Mi[p]
            if i >= j:
                continue
            # follow ancestors of i up to j, path-compressing
            while True:
                a = ancestor[i]
                if a == -1:
                    ancestor[i] = j
                    if parent[i] == -1:
                        parent[i] = j
                    break
                if a == j:
                    break
                ancestor[i] = j
                i = a
    return parent


@dataclasses.dataclass
class MFSymbolic:
    perm: np.ndarray               # AMD permutation applied (post-order id)
    sn_start: np.ndarray           # (nsn+1,) supernode column ranges
    rowsets: List[np.ndarray]      # per supernode: sorted rowset (incl cols)
    sn_parent: np.ndarray          # (nsn,) parent supernode or -1
    nnz_lu: int


def mf_symbolic(A: CSR, relax_width: int = 8,
                relax_fill: float = 0.25) -> Optional[MFSymbolic]:
    """AMD ordering + supernode partition of the symmetrized pattern.
    ``relax_width``/``relax_fill``: a child supernode of width ≤
    relax_width merges into its parent when the explicit-zero fill it
    introduces is ≤ relax_fill of the merged panel."""
    import scipy.sparse as sp
    from lssp_tpu_torch.sparse.reorder import amd_permutation
    n = A.shape[0]
    As = A.to_scipy().tocsr()
    # STRUCTURAL pattern (stored entries, incl. explicit zeros — assembled
    # FE matrices carry them and the numeric pass visits every stored slot)
    ones = sp.csr_matrix((np.ones(As.nnz), As.indices.copy(),
                          As.indptr.copy()), shape=As.shape)
    M = (ones + ones.T).tocsr()
    perm = np.asarray(amd_permutation(A), dtype=np.int64)
    M = M[perm][:, perm].tocsr()
    M.sort_indices()
    Mp, Mi = M.indptr.astype(np.int64), M.indices.astype(np.int64)
    parent = etree_sym(Mp, Mi, n)

    # POSTORDER the elimination tree and relabel: fundamental supernodes
    # are chains of CONSECUTIVE columns, which only exist after
    # postordering (measured: mean supernode width 1.5 on AMD order vs
    # the real chains after postorder).  Postorder preserves fill.
    children0: List[list] = [[] for _ in range(n)]
    roots = []
    for j in range(n):
        if parent[j] >= 0:
            children0[parent[j]].append(j)
        else:
            roots.append(j)
    post = np.empty(n, dtype=np.int64)
    k = 0
    for r in roots:
        stack = [(r, 0)]
        while stack:
            v, ci = stack[-1]
            if ci < len(children0[v]):
                stack[-1] = (v, ci + 1)
                stack.append((children0[v][ci], 0))
            else:
                stack.pop()
                post[k] = v
                k += 1
    rank = np.empty(n, dtype=np.int64)
    rank[post] = np.arange(n)
    perm = perm[post]
    parent = np.where(parent[post] >= 0, rank[np.maximum(parent[post], 0)],
                      -1)
    M = M[post][:, post].tocsr()
    M.sort_indices()
    Mp, Mi = M.indptr.astype(np.int64), M.indices.astype(np.int64)

    # bottom-up rowsets per column (sorted, col j first)
    rowset: List[Optional[np.ndarray]] = [None] * n
    children: List[list] = [[] for _ in range(n)]
    for j in range(n):
        if parent[j] >= 0:
            children[parent[j]].append(j)
    for j in range(n):
        below = Mi[Mp[j]:Mp[j + 1]]
        parts = [below[below >= j]]
        if j not in parts[0]:
            parts.append(np.array([j], dtype=np.int64))
        for c in children[j]:
            rc = rowset[c]
            parts.append(rc[rc > c])
            rowset[c] = rc            # keep (supernode pass reads them)
        rowset[j] = np.unique(np.concatenate(parts))

    # fundamental supernodes: j joins j-1 iff parent(j-1) == j and
    # |R(j-1)| == |R(j)| + 1
    starts = [0]
    for j in range(1, n):
        if not (parent[j - 1] == j
                and len(rowset[j - 1]) == len(rowset[j]) + 1):
            starts.append(j)
    starts.append(n)
    sn_start = np.asarray(starts, dtype=np.int64)
    nsn = len(sn_start) - 1
    sn_of = np.empty(n, dtype=np.int64)
    for s in range(nsn):
        sn_of[sn_start[s]:sn_start[s + 1]] = s
    rowsets = [rowset[sn_start[s]] for s in range(nsn)]
    sn_parent = np.full(nsn, -1, dtype=np.int64)
    for s in range(nsn):
        last = sn_start[s + 1] - 1
        if parent[last] >= 0:
            sn_parent[s] = sn_of[parent[last]]

    # relaxed amalgamation: merge a supernode into the NEXT one (keeps
    # column ranges contiguous) when the next supernode holds its parent
    # column and the explicit-zero cost of the merged panel is small
    # (fatter panels → better BLAS-3)
    if relax_width > 0:
        new_starts = [0]
        new_rowsets = []
        cur_rows = rowsets[0]
        cur_w = int(sn_start[1] - sn_start[0])
        cur_last = 0
        for t in range(1, nsn):
            w_t = int(sn_start[t + 1] - sn_start[t])
            can = sn_parent[cur_last] == t
            if can:
                merged = np.union1d(cur_rows, rowsets[t])
                real = len(cur_rows) * cur_w + len(rowsets[t]) * w_t
                cost = len(merged) * (cur_w + w_t)
                z = cost - real              # explicit zeros added
                wm = cur_w + w_t
                # graduated relaxation (CHOLMOD-style): small panels merge
                # nearly always — their per-supernode overhead dwarfs any
                # explicit-zero cost — larger ones need high density
                can = (wm <= 4 or
                       (wm <= 16 and z <= 0.30 * cost) or
                       (wm <= 48 and z <= 0.15 * cost) or
                       z <= 0.05 * cost)
            if can:
                cur_rows = merged
                cur_w += w_t
                cur_last = t
            else:
                new_starts.append(int(sn_start[t]))
                new_rowsets.append(cur_rows)
                cur_rows = rowsets[t]
                cur_w = w_t
                cur_last = t
        new_starts.append(n)
        new_rowsets.append(cur_rows)
        sn_start = np.asarray(new_starts, dtype=np.int64)
        rowsets = new_rowsets
        nsn = len(sn_start) - 1
        sn_of = np.empty(n, dtype=np.int64)
        for t in range(nsn):
            sn_of[sn_start[t]:sn_start[t + 1]] = t
        sn_parent = np.full(nsn, -1, dtype=np.int64)
        for t in range(nsn):
            last = sn_start[t + 1] - 1
            if parent[last] >= 0:
                sn_parent[t] = sn_of[parent[last]]

    nnz_lu = int(sum(2 * len(rowsets[s]) * (sn_start[s + 1] - sn_start[s])
                     for s in range(nsn)))
    return MFSymbolic(perm=perm, sn_start=sn_start, rowsets=rowsets,
                      sn_parent=sn_parent, nnz_lu=nnz_lu)


# --------------------------------------------------------------------------
# numeric
# --------------------------------------------------------------------------

def mf_factor_arrays(A: CSR, sym: MFSymbolic, pivot_tol: float = 0.1,
                     ztol: float = None, zval: float = None):
    """Numeric multifrontal factorization.  Returns (L_csr, U_csr, rowof,
    nclamped) in the permuted index space: rowof[j] = permuted-matrix row
    holding pivot j (block-restricted pivoting)."""
    import scipy.linalg as sla
    import scipy.sparse as sp
    ztol = Defaults.ZERO_DIAG_TOL if ztol is None else ztol
    zval = Defaults.ZERO_DIAG_VALUE if zval is None else zval
    n = A.shape[0]
    B = A.to_scipy().tocsr().astype(np.float64)
    B = B[sym.perm][:, sym.perm].tocsr()
    Bc = B.tocsc()
    sn_start, rowsets, sn_parent = sym.sn_start, sym.rowsets, sym.sn_parent
    nsn = len(sn_start) - 1
    pending: List[list] = [[] for _ in range(nsn)]
    rowof = np.arange(n, dtype=np.int64)
    nclamped = 0

    # output triplet collectors (L strict lower w/ unit diag implied; U
    # upper incl diag), row indices in PIVOT space
    Lr, Lc, Lv = [], [], []
    Ur, Uc, Uv = [], [], []

    for s in range(nsn):
        c0, c1 = int(sn_start[s]), int(sn_start[s + 1])
        w = c1 - c0
        R = rowsets[s]
        nR = len(R)
        F = np.zeros((nR, nR))
        # assemble A columns c0..c1 (rows in R) and rows c0..c1 (cols > c1)
        for j in range(c0, c1):
            lo, hi = Bc.indptr[j], Bc.indptr[j + 1]
            ri = Bc.indices[lo:hi]
            sel = ri >= c0
            F[np.searchsorted(R, ri[sel]), j - c0] += Bc.data[lo:hi][sel]
        for i in range(c0, c1):
            lo, hi = B.indptr[i], B.indptr[i + 1]
            ci = B.indices[lo:hi]
            sel = ci >= c1
            F[i - c0, np.searchsorted(R, ci[sel])] += B.data[lo:hi][sel]
        # extend-add children updates
        for (urows, Umat) in pending[s]:
            idx = np.searchsorted(R, urows)
            F[np.ix_(idx, idx)] += Umat
        pending[s] = []
        # dense partial factorization of the leading w×w block with
        # LAPACK row pivoting restricted to the block rows
        A11 = F[:w, :w]
        lu, piv = sla.lu_factor(A11, check_finite=False)
        # near-zero pivots: clamp on the factor's diagonal (the
        # library-wide ILU/LU guard, pc-iluk.cxx:367-374 semantics)
        d = np.abs(np.diag(lu))
        bad = d <= ztol
        if bad.any():
            nclamped += int(bad.sum())
            fix = np.where(np.diag(lu) >= 0, zval, -zval)
            lu[np.diag_indices(w)] = np.where(bad, fix, np.diag(lu))
        # apply the block row permutation
        pr = np.arange(w)
        for k, pk in enumerate(piv):
            pr[k], pr[pk] = pr[pk], pr[k]
        rowof[c0:c1] = (R[:w])[pr]
        L11 = np.tril(lu, -1) + np.eye(w)
        U11 = np.triu(lu)
        if nR > w:
            A21 = F[w:, :w]
            A12 = F[:w, w:][pr]              # rows permuted like A11
            L21 = sla.solve_triangular(U11, A21.T, lower=False,
                                       trans="T", check_finite=False).T
            U12 = sla.solve_triangular(L11, A12, lower=True,
                                       unit_diagonal=True,
                                       check_finite=False)
            S = F[w:, w:] - L21 @ U12
            p = int(sn_parent[s])
            if p >= 0:
                pending[p].append((R[w:], S))
        else:
            L21 = np.zeros((0, w))
            U12 = np.zeros((w, 0))
        # emit factor entries (pivot-space rows for L's sub-block rows are
        # resolved later — store permuted-matrix rows, remap at the end)
        jj = np.arange(c0, c1)
        li, lj = np.tril_indices(w, -1)
        Lr.append(rowof[c0 + li])            # matrix rows (remapped later)
        Lc.append(c0 + lj)
        Lv.append(L11[li, lj])
        Lr.append(np.repeat(R[w:], w))
        Lc.append(np.tile(jj, nR - w))
        Lv.append(L21.ravel())
        ui, uj = np.triu_indices(w)
        Ur.append(c0 + ui)
        Uc.append(c0 + uj)
        Uv.append(U11[ui, uj])
        Ur.append(np.repeat(jj, nR - w))
        Uc.append(np.tile(R[w:], w))
        Uv.append(U12.ravel())

    pinv = np.empty(n, dtype=np.int64)
    pinv[rowof] = np.arange(n)
    Lr = pinv[np.concatenate(Lr)] if Lr else np.zeros(0, np.int64)
    Lc = np.concatenate(Lc) if Lc else np.zeros(0, np.int64)
    Lv = np.concatenate(Lv) if Lv else np.zeros(0)
    import scipy.sparse as sp2
    Lm = sp2.csr_matrix((Lv, (Lr, Lc)), shape=(n, n))
    Lm.eliminate_zeros()
    Um = sp2.csr_matrix((np.concatenate(Uv) if Uv else np.zeros(0),
                         (np.concatenate(Ur) if Ur else np.zeros(0, np.int64),
                          np.concatenate(Uc) if Uc else np.zeros(0, np.int64))),
                        shape=(n, n))
    Um.eliminate_zeros()
    return (CSR.from_scipy(Lm.tocsr()), CSR.from_scipy(Um.tocsr()),
            rowof, nclamped)


def _mf_factor_native(A: CSR, ztol: float, zval: float):
    """C++ symbolic + numeric fast path (native/src/mf.cpp; BLAS/LAPACK
    through scipy's cython capsules).  Returns SpLU or None."""
    import scipy.sparse as sp
    from lssp_tpu_torch import native
    from lssp_tpu_torch.pc.lu_host import SpLU
    from lssp_tpu_torch.sparse.reorder import amd_permutation
    if not native.available():
        return None
    n = A.shape[0]
    As = A.to_scipy().tocsr()
    ones = sp.csr_matrix((np.ones(As.nnz), As.indices.copy(),
                          As.indptr.copy()), shape=As.shape)
    M = (ones + ones.T).tocsr()
    perm0 = np.asarray(amd_permutation(A), dtype=np.int64)
    M = M[perm0][:, perm0].tocsr()
    M.sort_indices()
    out = native.mf_symbolic(M.indptr, M.indices, n)
    if out is None:
        return None
    post, sn_start, sn_parent, rs_ptr, rs_idx = out
    perm = perm0[post]
    B = As.astype(np.float64)[perm][:, perm]
    Bcsr = B.tocsr()
    Bcsc = B.tocsc()
    num = native.mf_numeric(Bcsr, Bcsc, sn_start, sn_parent, rs_ptr,
                            rs_idx, ztol, zval)
    if num is None:
        return None
    Lr, Lc, Lv, Ur, Uc, Uv, rowof, ncl = num
    pinv = np.empty(n, dtype=np.int64)
    pinv[rowof] = np.arange(n)
    from lssp_tpu_torch.sparse.utils import transpose
    # L arrives grouped by ascending column (CSC layout): build the CSR
    # of Lᵀ directly, then one counting transpose — no scipy COO sort
    keepL = Lv != 0.0
    LcK, LrK, LvK = Lc[keepL], pinv[Lr[keepL]], Lv[keepL]
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(LcK, minlength=n), out=lptr[1:])
    Lcsr = transpose(CSR(lptr, LrK, LvK, (n, n)))
    # U arrives grouped by ascending pivot row: direct CSR
    keepU = Uv != 0.0
    UrK, UcK, UvK = Ur[keepU], Uc[keepU], Uv[keepU]
    uptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(UrK, minlength=n), out=uptr[1:])
    Ucsr = CSR(uptr.astype(np.int64), UcK, UvK, (n, n))
    perm_in = perm[rowof]
    perm_out = np.argsort(perm)
    return SpLU(L=Lcsr, U=Ucsr,
                perm_in=perm_in.astype(np.int32),
                perm_out=perm_out.astype(np.int32), nclamped=int(ncl))


def mf_factor(A: CSR, pivot_tol: float = 0.1, ztol: float = None,
              zval: float = None, relax_width: int = 8):
    """Full supernodal factorization → the shared ``SpLU`` container
    (pc/lu_host.py), so every downstream consumer (device triangular
    sweeps, pc='lu', method='direct', solve_ir) works unchanged."""
    from lssp_tpu_torch.pc.lu_host import SpLU
    ztol_ = Defaults.ZERO_DIAG_TOL if ztol is None else ztol
    zval_ = Defaults.ZERO_DIAG_VALUE if zval is None else zval
    out = _mf_factor_native(A, ztol_, zval_)
    if out is not None:
        return out
    sym = mf_symbolic(A, relax_width=relax_width)
    L, U, rowof, ncl = mf_factor_arrays(A, sym, pivot_tol=pivot_tol,
                                        ztol=ztol, zval=zval)
    perm = sym.perm
    # pivot j holds permuted-matrix row rowof[j] = original row perm[rowof[j]]
    perm_in = perm[rowof]
    perm_out = np.argsort(perm)
    return SpLU(L=L, U=U, perm_in=perm_in.astype(np.int32),
                perm_out=perm_out.astype(np.int32), nclamped=int(ncl))
