"""Host-side CSR structural utilities (numpy, run once at assembly time).

Same semantics as ``lssp_tpu/sparse/utils.py`` (reference
matrix-utils.cxx: column sort :387-481, transpose :700-765, zero-diagonal
repair :483-587).
"""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.sparse.types import CSR


def _row_ids(indptr, n) -> np.ndarray:
    ip = np.asarray(indptr).astype(np.int64)
    return np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])


def _build(n, rows, cols, vals, shape) -> CSR:
    """Row-sorted CSR from triplets (stable within equal keys)."""
    p = np.zeros(n + 1, dtype=np.int64)
    np.add.at(p, rows + 1, 1)
    p = np.cumsum(p)
    order = np.lexsort((cols, rows))
    return CSR(p.astype(np.int32), cols[order].astype(np.int32), vals[order], shape)


def is_sorted(A: CSR) -> bool:
    """True iff column indices are ascending within every row."""
    ip = np.asarray(A.indptr)
    idx = np.asarray(A.indices)
    if len(idx) == 0:
        return True
    rising = np.ones(len(idx), dtype=bool)
    rising[1:] = idx[1:] > idx[:-1]
    # row starts may go backwards; trailing empty rows make ip[1:-1] hit nnz
    starts = ip[1:-1]
    rising[starts[starts < len(idx)]] = True
    return bool(rising.all())


def sort_columns(A: CSR) -> CSR:
    """Sort column indices within each row (reference lssp_mat_sort_column)."""
    if is_sorted(A):
        return A
    rows = _row_ids(A.indptr, A.shape[0])
    order = np.lexsort((np.asarray(A.indices), rows))
    return CSR(A.indptr, np.asarray(A.indices)[order], np.asarray(A.data)[order],
               A.shape)


def transpose(A: CSR) -> CSR:
    """CSR transpose (reference lssp_mat_transpose)."""
    n, m = A.shape
    rows = _row_ids(A.indptr, n)
    cols = np.asarray(A.indices).astype(np.int64)
    return _build(m, cols, rows, np.asarray(A.data), (m, n))


def diagonal(A: CSR) -> np.ndarray:
    """The main diagonal (missing entries → 0)."""
    rows = _row_ids(A.indptr, A.shape[0])
    cols = np.asarray(A.indices).astype(np.int64)
    d = np.zeros(min(A.shape), dtype=A.data.dtype)
    hit = rows == cols
    d[rows[hit]] = np.asarray(A.data)[hit]
    return d


def adjust_zero_diag(A: CSR, tol: float = 1e-10) -> CSR:
    """Insert a diagonal entry of value ``tol`` into rows that lack one
    (reference lssp_mat_adjust_zero_diag; the inserted value is the tol
    argument, matrix-utils.cxx:564)."""
    n = A.shape[0]
    rows = _row_ids(A.indptr, n)
    cols = np.asarray(A.indices).astype(np.int64)
    has_diag = np.zeros(n, dtype=bool)
    has_diag[rows[rows == cols]] = True
    missing = np.nonzero(~has_diag)[0]
    if len(missing) == 0:
        return A
    return _build(n, np.concatenate([rows, missing]),
                  np.concatenate([cols, missing]),
                  np.concatenate([np.asarray(A.data),
                                  np.full(len(missing), tol, dtype=A.data.dtype)]),
                  A.shape)


def block_diag_extract(A: CSR, num_blocks: int) -> CSR:
    """The entries inside the block-diagonal partition of ``num_blocks``
    uniform row blocks; a row whose diagonal block is empty gets a unit
    diagonal (reference lssp_mat_get_block_diag, matrix-utils.cxx:589-698,
    empty rows padded with identity at :680-685)."""
    n = A.shape[0]
    bs = n // num_blocks
    if bs * num_blocks != n:
        raise ValueError(f"n={n} not divisible into {num_blocks} blocks")
    rows = _row_ids(A.indptr, n)
    cols = np.asarray(A.indices).astype(np.int64)
    keep = (rows // bs) == (cols // bs)
    rows, cols = rows[keep], cols[keep]
    dat = np.asarray(A.data)[keep]
    empty = np.nonzero(np.bincount(rows, minlength=n) == 0)[0]
    if len(empty):
        rows = np.concatenate([rows, empty])
        cols = np.concatenate([cols, empty])
        dat = np.concatenate([dat, np.ones(len(empty), dtype=dat.dtype)])
    return _build(n, rows, cols, dat, A.shape)


def split_lu(F: CSR):
    """Split a combined LU factor into a strictly lower L (unit diagonal
    implied) and an upper U that holds the diagonal."""
    n = F.shape[0]
    rows = _row_ids(F.indptr, n)
    cols = np.asarray(F.indices).astype(np.int64)
    dat = np.asarray(F.data)
    lower = cols < rows
    upper = ~lower
    return (_build(n, rows[lower], cols[lower], dat[lower], F.shape),
            _build(n, rows[upper], cols[upper], dat[upper], F.shape))


def split_ldu(A: CSR):
    """Split into strict lower L, diagonal vector d, strict upper U."""
    n = A.shape[0]
    rows = _row_ids(A.indptr, n)
    cols = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    d = np.zeros(n, dtype=dat.dtype)
    on = rows == cols
    d[rows[on]] = dat[on]
    lo, up = cols < rows, cols > rows
    return (_build(n, rows[lo], cols[lo], dat[lo], A.shape), d,
            _build(n, rows[up], cols[up], dat[up], A.shape))
