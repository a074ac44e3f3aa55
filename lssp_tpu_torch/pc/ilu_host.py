"""Host-side ILU factorizations (numpy around the native C++ kernels).

Same algorithms and the same native code as ``lssp_tpu/pc/ilu_host.py``, so
the factors are bit-identical:

- ``iluk_symbolic``: level-of-fill pattern growth (reference
  pc-iluk.cxx:22-135, including its max-level update rule);
- ``ilu0_numeric``: IKJ elimination on a fixed sorted pattern with the
  reference's pivot clamps (pc-iluk.cxx:347-409);
- ``ilut_factor``: Saad's dual-threshold ILUT (pc-ilut.cxx:51-286);
- ``ilutp_factor``: ILUT with column pivoting (the LIS ``ilutp``), a pure
  Python heap loop as JAX's.

The ILU(k) and ILUT entry points first run ``adjust_zero_diag`` so a structural
diagonal always exists.  Every input dtype is factored in fp64 and rounded
once at the end.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch import native
from lssp_tpu_torch.config import Defaults
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.sparse.utils import adjust_zero_diag, sort_columns, split_lu


def iluk_symbolic(A: CSR, level: int) -> CSR:
    """Level-of-fill symbolic phase: the combined L+U pattern as a sorted CSR
    with zeroed data slots."""
    ip, idx = native.iluk_symbolic(np.asarray(A.indptr), np.asarray(A.indices),
                                   A.shape[0], level)
    return CSR(ip.astype(np.int32), idx.astype(np.int32),
               np.zeros(len(idx), dtype=A.data.dtype), A.shape)


def _set_values_from(pattern: CSR, A: CSR) -> CSR:
    """Scatter A's values onto the (superset) pattern; fill slots get 0."""
    n = A.shape[0]
    pip = np.asarray(pattern.indptr).astype(np.int64)
    pidx = np.asarray(pattern.indices).astype(np.int64)
    aip = np.asarray(A.indptr).astype(np.int64)
    aidx = np.asarray(A.indices).astype(np.int64)
    data = np.zeros(len(pidx), dtype=np.asarray(A.data).dtype)
    # both are row-sorted with ascending columns, so row·n + col is strictly
    # increasing in each: one searchsorted places every entry
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(aip))
    prows = np.repeat(np.arange(n, dtype=np.int64), np.diff(pip))
    data[np.searchsorted(prows * n + pidx, arows * n + aidx)] = np.asarray(A.data)
    return CSR(pattern.indptr, pattern.indices, data, pattern.shape)


def ilu0_numeric(M: CSR) -> CSR:
    """IKJ ILU(0) on the fixed sorted pattern of ``M``: the combined factor
    (L multipliers strictly below, U with the diagonal)."""
    out_dtype = np.asarray(M.data).dtype
    out = native.ilu0(np.asarray(M.indptr), np.asarray(M.indices),
                      np.asarray(M.data).astype(np.float64),
                      Defaults.ZERO_DIAG_TOL, Defaults.ZERO_DIAG_VALUE)
    return CSR(M.indptr, M.indices, out.astype(out_dtype, copy=False), M.shape)


def iluk_factor(A: CSR, level: int = 1, num_blocks: int = 1):
    """ILU(k): zero-diagonal repair → symbolic (level > 0) → numeric → L/U
    split.  ``num_blocks > 1`` factors each uniform diagonal block on its
    own (the reference's block-Jacobi ILU).  Returns (L strictly lower,
    unit diagonal implied; U upper with the diagonal)."""
    if num_blocks > 1:
        return _factor_block_diag(A, num_blocks, lambda B: iluk_factor(B, level))
    A = sort_columns(adjust_zero_diag(A, Defaults.ZERO_DIAG_TOL))
    if level <= 0:
        M = CSR(A.indptr, A.indices, np.asarray(A.data).copy(), A.shape)
    else:
        M = _set_values_from(iluk_symbolic(A, level), A)
    return split_lu(ilu0_numeric(M))


def ilut_factor(A: CSR, tol: float = None, p: int = None, num_blocks: int = 1):
    """Dual-threshold ILUT (reference lssp_pc_ilut_fac).  Returns (L, U)
    as ``iluk_factor`` does."""
    if num_blocks > 1:
        return _factor_block_diag(A, num_blocks, lambda B: ilut_factor(B, tol, p))
    n = A.shape[0]
    if tol is None or tol < 0:
        tol = Defaults.ILUT_TOL
    if p is None or p <= 0:
        p = (A.nnz + n - 1) // n
    A = sort_columns(adjust_zero_diag(A, Defaults.ZERO_DIAG_TOL))
    out_dtype = np.asarray(A.data).dtype
    ip, idx, dat = native.ilut(np.asarray(A.indptr), np.asarray(A.indices),
                               np.asarray(A.data).astype(np.float64), n,
                               float(tol), int(p), Defaults.ZERO_DIAG_TOL,
                               Defaults.ZERO_DIAG_VALUE)
    return split_lu(CSR(ip.astype(np.int32), idx.astype(np.int32),
                        dat.astype(out_dtype, copy=False), A.shape))


def _factor_block_diag(A: CSR, num_blocks: int, factor_fn):
    """Factor each uniform diagonal block independently and reassemble the
    global L/U (reference pc-iluk.cxx:411-552)."""
    n = A.shape[0]
    bs = n // num_blocks
    if bs * num_blocks != n:
        raise ValueError(f"n={n} not divisible into {num_blocks} blocks")
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    Ls, Us = [], []
    for b in range(num_blocks):
        lo, hi = b * bs, (b + 1) * bs
        rows = slice(ip[lo], ip[hi])
        keep = (idx[rows] >= lo) & (idx[rows] < hi)
        sub_counts = np.zeros(bs + 1, dtype=np.int64)
        row_of = np.repeat(np.arange(bs), ip[lo + 1:hi + 1] - ip[lo:hi])
        np.add.at(sub_counts, row_of[keep] + 1, 1)
        sub = CSR(np.cumsum(sub_counts).astype(np.int32),
                  (idx[rows][keep] - lo).astype(np.int32), dat[rows][keep], (bs, bs))
        L_b, U_b = factor_fn(sub)
        Ls.append(L_b)
        Us.append(U_b)
    return _stack_block_diag(Ls, n), _stack_block_diag(Us, n)


def _stack_block_diag(blocks, n):
    """Block-diagonal CSR from per-block CSR factors."""
    bs = blocks[0].shape[0]
    ips, idxs, dats = [np.zeros(1, dtype=np.int64)], [], []
    off = 0
    for b, B in enumerate(blocks):
        bip = np.asarray(B.indptr).astype(np.int64)
        ips.append(bip[1:] + off)
        idxs.append(np.asarray(B.indices).astype(np.int64) + b * bs)
        dats.append(np.asarray(B.data))
        off += bip[-1]
    return CSR(np.concatenate(ips).astype(np.int32),
               np.concatenate(idxs).astype(np.int32), np.concatenate(dats), (n, n))


def ilutp_factor(A: CSR, tol: float = None, p: int = None,
                 permtol: float = 0.1):
    """ILUTP — dual-threshold ILU with column pivoting (Saad; the LIS
    adapter's ``ilutp`` capability, solver-lis.cxx:8-41).  A copy of
    ``lssp_tpu/pc/ilu_host.py: ilutp_factor`` (the same heap loop), so L, U
    and perm come out bit for bit as JAX's.

    Row-wise ILUT elimination with a column permutation: after eliminating
    row i, if the diagonal candidate is smaller than ``permtol`` times the
    largest upper-part entry, the diagonal column is swapped with that
    entry's column.  Robust on matrices with small/zero diagonals where
    plain ILUT must clamp pivots.

    Returns (L, U, perm): strict-lower L and upper U (both in the pivot
    position space) with L·U ≈ A[:, perm].  The PC apply is
    z[c] = (U⁻¹L⁻¹ r)[iperm[c]] (``pc/ilu.py: setup_ilutp``).
    """
    n = A.shape[0]
    tol = Defaults.ILUT_TOL if tol is None else tol
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data).astype(np.float64)
    if p is None or p <= 0:
        p = max(1, int(np.ceil(A.nnz / max(1, n))))

    perm = np.arange(n, dtype=np.int64)       # position -> original column
    iperm = np.arange(n, dtype=np.int64)      # original column -> position
    Lrows = []                                # [(positions, vals)]
    Udiag = np.zeros(n)
    Urows = []                                # [(orig cols, vals)] strict

    import heapq
    for i in range(n):
        s, e = ip[i], ip[i + 1]
        w = {int(c): float(v) for c, v in zip(idx[s:e], dat[s:e])}
        orig = set(w)                         # original pattern: never
        rnorm = float(np.mean(np.abs(dat[s:e]))) if e > s else 1.0
        droptol = tol * rnorm                 # tolerance-gated (fills only)

        pending = [int(iperm[c]) for c in w if iperm[c] < i]
        heapq.heapify(pending)
        done = set()
        while pending:
            k = heapq.heappop(pending)
            if k in done:
                continue
            done.add(k)
            c_k = int(perm[k])
            if c_k not in w:
                continue
            lik = w[c_k] / Udiag[k]
            if abs(lik) < droptol and c_k not in orig:
                del w[c_k]
                continue
            w[c_k] = lik
            ucols, uvals = Urows[k]
            for c_j, u in zip(ucols, uvals):
                c_j = int(c_j)
                upd = lik * u
                if c_j in w:
                    w[c_j] -= upd
                elif abs(upd) >= droptol:
                    w[c_j] = -upd
                    if iperm[c_j] < i:
                        heapq.heappush(pending, int(iperm[c_j]))

        lpart = [(int(iperm[c]), v) for c, v in w.items() if iperm[c] < i]
        upart = [(int(c), v) for c, v in w.items() if iperm[c] >= i]
        # keep-p largest (diagonal handled after the pivot decision)
        lpart.sort(key=lambda kv: -abs(kv[1]))
        lpart = lpart[:p]

        # pivot: prefer the current diagonal column unless it is permtol-
        # dominated by another upper-part entry
        c_diag = int(perm[i])
        best_c, best_v = c_diag, abs(w.get(c_diag, 0.0))
        for c, v in upart:
            if abs(v) > best_v:
                best_c, best_v = c, abs(v)
        if best_c != c_diag and \
                abs(w.get(c_diag, 0.0)) < permtol * best_v:
            # swap positions of c_diag and best_c
            pi, pj = int(iperm[c_diag]), int(iperm[best_c])
            perm[pi], perm[pj] = perm[pj], perm[pi]
            iperm[c_diag], iperm[best_c] = pj, pi
            c_diag = best_c
        dval = w.pop(c_diag, 0.0)
        if abs(dval) <= Defaults.ZERO_DIAG_TOL:
            dval = Defaults.ZERO_DIAG_VALUE if dval >= 0 \
                else -Defaults.ZERO_DIAG_VALUE
        upart = [(c, v) for c, v in w.items() if iperm[c] > i]
        upart.sort(key=lambda kv: -abs(kv[1]))
        upart = [(c, v) for c, v in upart[:p]
                 if abs(v) >= droptol or c in orig]

        Lrows.append((np.array([k for k, _ in sorted(lpart)], np.int64),
                      np.array([v for _, v in sorted(lpart)])))
        Udiag[i] = dval
        Urows.append((np.array([c for c, _ in upart], np.int64),
                      np.array([v for _, v in upart])))

    def build(rows_list, diag=None, map_cols=False):
        ptr = np.zeros(n + 1, dtype=np.int64)
        cols_all, vals_all = [], []
        for i, (cs, vs) in enumerate(rows_list):
            cs = iperm[cs] if map_cols else cs
            if diag is not None:
                cs = np.concatenate([[i], cs])
                vs = np.concatenate([[diag[i]], vs])
            order = np.argsort(cs, kind="stable")
            cols_all.append(cs[order])
            vals_all.append(vs[order])
            ptr[i + 1] = ptr[i] + len(cs)
        return CSR(ptr,
                   (np.concatenate(cols_all) if cols_all else
                    np.zeros(0, np.int64)).astype(np.int64),
                   np.concatenate(vals_all) if vals_all else np.zeros(0),
                   (n, n))

    L = build(Lrows)
    U = build(Urows, diag=Udiag, map_cols=True)
    return L, U, perm
