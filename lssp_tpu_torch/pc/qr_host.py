"""Host sparse QR factorization — George–Heath row-merging Givens QR.

The port of ``lssp_tpu/pc/qr_host.py`` (the same merge order and the same
C++ merge loop ``native/src/spqr.cpp``, so R comes out bit for bit as
JAX's).  Capability parity with the reference's QR_MUMPS adapter
(solver-qrmumps.cxx:10-84: analyse / factorize / apply Qᵀ / solve R), in
place of normal equations, whose accuracy is capped by the *squared*
condition number.

Algorithm (George & Heath 1980): rows of A are merged into a sparse upper
-triangular R one at a time; each merge eliminates the working row's
leading entries with Givens rotations against the stored R rows.  Q is
never formed — the rotations are applied to the right-hand side on the
fly, so the factor-time solve is a genuine orthogonal-factorization least
-squares solve (error ∝ cond(A), not cond(A)²).  Re-solves with new right
-hand sides use the stored R via corrected seminormal equations (CSNE:
RᵀR x = Aᵀb plus one refinement step), the standard Q-less scheme.

Column ordering: bandwidth-reducing RCM on the AᵀA pattern (COLAMD is not
available in this environment; RCM bounds the fill of R within the
permuted band, which is the same role).  Rows are processed in order of
their leading column, the standard George–Heath schedule.

Everything here is host/numpy (setup path); the solve products A·x / Aᵀ·r
in CSNE are host scipy ops.  For large systems use the iterative route
(``solve(method="lsqr")``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from lssp_tpu_torch.sparse.types import CSR


@dataclasses.dataclass
class QRFactors:
    """Sparse R (list-of-rows) + column permutation.

    ``Rrows[j] = (cols, vals)`` with cols ascending, cols[0] == j (the
    diagonal); entries are in PERMUTED column indices.  ``cperm`` maps
    permuted -> original column; ``c`` is Qᵀb for the factor-time rhs (None
    when factored without one); ``resnorm`` the corresponding residual.
    """

    Rrows: list
    cperm: np.ndarray
    n: int
    m: int
    c: Optional[np.ndarray] = None
    resnorm: float = 0.0
    A_scipy: Any = None          # kept for CSNE re-solves


def _col_order(A_scipy) -> np.ndarray:
    """RCM on the AᵀA pattern (fill-bounding column ordering)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    G = (A_scipy.T @ A_scipy).tocsr()
    G.data[:] = 1.0
    perm = reverse_cuthill_mckee(G, symmetric_mode=True)
    return np.asarray(perm, dtype=np.int64)


def _merge_rotate(rc, rv, wc, wv, c, s):
    """Apply the Givens rotation [[c, s], [-s, c]] to the sparse row pair
    (R_row, w) over the union of their supports.  Returns the two new
    (cols, vals) pairs; the w entry at the pivot (rc[0]) cancels exactly
    and is dropped."""
    union = np.union1d(rc, wc)
    r_full = np.zeros(len(union))
    w_full = np.zeros(len(union))
    r_full[np.searchsorted(union, rc)] = rv
    w_full[np.searchsorted(union, wc)] = wv
    new_r = c * r_full + s * w_full
    new_w = -s * r_full + c * w_full
    new_w[0] = 0.0                     # exact cancellation at the pivot
    keep_r = new_r != 0.0
    keep_r[0] = True                   # diagonal stays even if tiny
    keep_w = new_w != 0.0
    return (union[keep_r], new_r[keep_r]), (union[keep_w], new_w[keep_w])


def qr_factor(A: CSR, b=None) -> QRFactors:
    """Factor A (m×n, m ≥ n, full column rank) as Q·R with column RCM.

    When ``b`` is given, Qᵀb is accumulated through the rotations and the
    least-squares residual norm ‖b − A·x‖ falls out of the annihilated
    rows' leftovers.
    """
    As = A.to_scipy().tocsr().astype(np.float64)
    m, n = As.shape
    if m < n:
        raise ValueError(f"qr_factor needs m >= n, got {As.shape}")
    cperm = _col_order(As)             # permuted j <- original cperm[j]
    inv = np.empty(n, dtype=np.int64)
    inv[cperm] = np.arange(n)
    Ap = As[:, cperm].tocsr()
    Ap.sort_indices()

    bn = None if b is None else np.asarray(b, np.float64).copy()
    Rrows = [None] * n
    crhs = np.zeros(n)
    res2 = 0.0

    ip, idx, dat = Ap.indptr.astype(np.int64), Ap.indices.astype(np.int64), Ap.data
    # process rows by leading column (George–Heath schedule); a matrix with
    # zero stored entries degenerates to all-residual rows + unit diagonals
    if len(idx) == 0:
        lead = np.full(m, n, dtype=np.int64)
    else:
        lead = np.where(np.diff(ip) > 0,
                        idx[np.minimum(ip[:-1], len(idx) - 1)], n)
    order = np.argsort(lead, kind="stable")

    from lssp_tpu_torch import native
    if native.available():
        # C++ merge loop (~100× the Python oracle); pre-reorder the rows
        rn = np.diff(ip)
        ip2 = np.concatenate([[0], np.cumsum(rn[order])]).astype(np.int64)
        pos = np.arange(len(idx), dtype=np.int64)
        # row-gather of the nnz ranges in `order`
        take = np.concatenate(
            [pos[ip[i]:ip[i + 1]] for i in order]) if len(idx) else pos[:0]
        b2 = None if bn is None else bn[order]
        Rp, Rj, Rx, crhs, res2 = native.spqr(
            ip2, idx[take], np.asarray(dat)[take], m, n, b2)
        # numerically rank-deficient pivots (explicit stored zeros) get the
        # same unit-diagonal clamp as structurally empty columns
        Rx[Rp[:-1][Rx[Rp[:-1]] == 0.0]] = 1.0
        Rrows = [(Rj[Rp[j]:Rp[j + 1]], Rx[Rp[j]:Rp[j + 1]])
                 for j in range(n)]
        return QRFactors(Rrows=Rrows, cperm=cperm, n=n, m=m,
                         c=crhs if b is not None else None,
                         resnorm=float(np.sqrt(res2)), A_scipy=As)

    for i in order:
        s_, e_ = ip[i], ip[i + 1]
        if s_ == e_:
            if bn is not None:
                res2 += bn[i] ** 2
            continue
        wc, wv = idx[s_:e_].copy(), dat[s_:e_].copy()
        beta = 0.0 if bn is None else bn[i]
        while len(wc):
            j = int(wc[0])
            if Rrows[j] is None:
                Rrows[j] = (wc, wv)
                crhs[j] = beta
                beta = 0.0
                break
            rc, rv = Rrows[j]
            a, bb = rv[0], wv[0]
            h = np.hypot(a, bb)
            # both leading values exactly zero (explicit stored zeros):
            # identity rotation instead of 0/0 = NaN
            c, s = (1.0, 0.0) if h == 0 else (a / h, bb / h)
            Rrows[j], (wc, wv) = _merge_rotate(rc, rv, wc, wv, c, s)
            crhs[j], beta = c * crhs[j] + s * beta, -s * crhs[j] + c * beta
        else:
            # row fully annihilated: its rotated rhs is pure residual
            # (stored rows zero their beta before break, so this is the
            # only accumulation — counting it again double-books res2)
            res2 += beta ** 2

    # empty columns (structurally rank-deficient) and exact-zero pivots
    # (numerically rank-deficient, e.g. explicit stored zeros): unit
    # diagonal so back-substitution stays defined (pivot-clamp convention)
    for j in range(n):
        if Rrows[j] is None:
            Rrows[j] = (np.array([j], np.int64), np.array([1.0]))
            crhs[j] = 0.0
        elif Rrows[j][1][0] == 0.0:
            Rrows[j][1][0] = 1.0
    return QRFactors(Rrows=Rrows, cperm=cperm, n=n, m=m,
                     c=crhs if b is not None else None,
                     resnorm=float(np.sqrt(res2)), A_scipy=As)


def _r_backsolve(f: QRFactors, rhs: np.ndarray) -> np.ndarray:
    """x (permuted frame) from R x = rhs."""
    x = np.zeros(f.n)
    for j in range(f.n - 1, -1, -1):
        cols, vals = f.Rrows[j]
        acc = rhs[j]
        if len(cols) > 1:
            acc -= vals[1:] @ x[cols[1:]]
        x[j] = acc / vals[0]
    return x


def _rt_forwardsolve(f: QRFactors, rhs: np.ndarray) -> np.ndarray:
    """y (permuted frame) from Rᵀ y = rhs (column-sweep on R's rows)."""
    y = rhs.astype(np.float64).copy()
    for j in range(f.n):
        cols, vals = f.Rrows[j]
        y[j] = y[j] / vals[0]
        if len(cols) > 1:
            y[cols[1:]] -= vals[1:] * y[j]
    return y


def qr_solve_minnorm(f: QRFactors, b, refine: int = 1) -> np.ndarray:
    """Minimum-norm solution of the UNDERdetermined system A x = b, where
    ``f = qr_factor(transpose(A))`` (A is m×n with m < n, so Aᵀ is tall).

    With AᵀP = QR:  AAᵀ = P RᵀR Pᵀ, so the min-norm solution
    x = Aᵀ(AAᵀ)⁻¹b = Aᵀ·P·R⁻¹(R⁻ᵀ(Pᵀb)) needs only the stored R (Q-less),
    plus ``refine`` correction steps for conditioning."""
    At = f.A_scipy                      # scipy CSR of Aᵀ, shape (n, m)
    bn = np.asarray(b, np.float64)

    def apply(r):
        w = _r_backsolve(f, _rt_forwardsolve(f, r[f.cperm]))
        wp = np.zeros(f.n)
        wp[f.cperm] = w
        return At @ wp                  # Aᵀ · P w

    x = apply(bn)
    for _ in range(max(0, refine)):
        r = bn - At.T @ x               # b − A x
        x = x + apply(r)
    return x


def qr_solve(f: QRFactors, b=None, refine: int = 1) -> np.ndarray:
    """Least-squares solve min ‖Ax − b‖.

    With ``b is None`` the factor-time rhs (Qᵀb accumulated through the
    rotations) is used — full orthogonal accuracy.  A new ``b`` goes
    through CSNE (RᵀR x = Aᵀb) with ``refine`` correction steps."""
    n = f.n
    if b is None:
        if f.c is None:
            raise ValueError("factored without a rhs; pass b")
        xp = _r_backsolve(f, f.c)
    else:
        bn = np.asarray(b, np.float64)
        atb = (f.A_scipy.T @ bn)[f.cperm]
        xp = _r_backsolve(f, _rt_forwardsolve(f, atb))
        for _ in range(max(0, refine)):
            x0 = np.zeros(n)
            x0[f.cperm] = xp        # unpermute... (x_orig = P x_perm)
            r = bn - f.A_scipy @ x0
            atr = (f.A_scipy.T @ r)[f.cperm]
            xp = xp + _r_backsolve(f, _rt_forwardsolve(f, atr))
    x = np.zeros(n)
    x[f.cperm] = xp
    return x
