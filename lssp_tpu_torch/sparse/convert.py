"""Host-side format conversions (numpy), run once at assembly time.

Same rules as ``lssp_tpu/sparse/convert.py``: COO→CSR is a counting sort
that sums duplicates (reference matrix-utils.cxx:324-380); DIA and ELL are
the execution formats, built on the host and handed out as tensors on the
requested device.  HYB (band plus remainder) is not carried yet:
``to_device_format`` takes ELL where the JAX package would try HYB.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.sparse.types import COO, CSR, DIA, ELL


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def csr_entry_offsets(indptr, indices, n):
    """Per-entry diagonal offsets (col − row) and their sorted unique set,
    by a counting pass.  Returns ``(rows, d, offs)``, int32 when 2n < 2³¹.
    Square matrices only: offsets must lie in [-(n-1), n-1]."""
    ip = np.asarray(indptr)
    it = np.int32 if 2 * n < 2**31 else np.int64
    rows = np.repeat(np.arange(n, dtype=it), np.diff(ip))
    d = np.asarray(indices).astype(it, copy=False) - rows
    if len(d) and int(d.max()) > n - 1:
        raise ValueError(f"csr_entry_offsets: square-only (max offset "
                         f"{int(d.max())} > n-1={n - 1})")
    if len(d) == 0:
        return rows, d, np.zeros(0, dtype=it)
    occ = np.bincount(d + it(n - 1), minlength=2 * n - 1)
    offs = (np.flatnonzero(occ) - (n - 1)).astype(it)
    return rows, d, offs


def coo_to_csr(A: COO, sum_duplicates: bool = True) -> CSR:
    """Counting-sort COO→CSR, summing duplicate entries
    (reference lssp_mat_coo_to_csr)."""
    n, m = A.shape
    row = np.asarray(A.row, dtype=np.int64)
    col = np.asarray(A.col, dtype=np.int64)
    dat = np.asarray(A.data)
    order = np.lexsort((col, row))
    row, col, dat = row[order], col[order], dat[order]
    if sum_duplicates and len(row):
        keys = row * m + col
        uniq = np.empty(len(keys), dtype=bool)
        uniq[0] = True
        np.not_equal(keys[1:], keys[:-1], out=uniq[1:])
        seg = np.cumsum(uniq) - 1
        dat = np.bincount(seg, weights=dat, minlength=seg[-1] + 1).astype(dat.dtype)
        row, col = row[uniq], col[uniq]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr.astype(np.int32), col.astype(np.int32), dat, (n, m))


def csr_to_ell(A: CSR, pad_to: int = 4, device="cpu") -> ELL:
    """CSR→padded ELLPACK on ``device``; padded slots get (col=0, val=0).
    ``k`` is the longest row rounded up to a multiple of ``pad_to``."""
    n, _ = A.shape
    ip = np.asarray(A.indptr).astype(np.int64)
    rn = ip[1:] - ip[:-1]
    k = max(1, _round_up(int(rn.max()) if n else 1, pad_to))
    cols = np.zeros((n, k), dtype=np.int64)
    data = np.zeros((n, k), dtype=A.data.dtype)
    pos = np.arange(k)[None, :] < rn[:, None]
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[pos]
    cols[pos] = np.asarray(A.indices)[flat]
    data[pos] = np.asarray(A.data)[flat]
    return ELL(torch.from_numpy(cols).to(device), torch.from_numpy(data).to(device),
               A.shape)


def csr_to_dia(A: CSR, max_diags: int = 64, dtype=None, device="cpu") -> DIA:
    """CSR→diagonal storage on ``device`` (row-aligned: data[d, i] =
    A[i, i+off]).  Raises ``ValueError`` beyond ``max_diags`` distinct
    diagonals.  ``dtype`` (numpy) casts during the scatter."""
    n, _ = A.shape
    out_dtype = np.dtype(dtype or np.asarray(A.data).dtype)
    rows, d, offs = csr_entry_offsets(A.indptr, A.indices, n)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} diagonals > max_diags={max_diags}")
    data = np.zeros((len(offs), n), dtype=out_dtype)
    data[np.searchsorted(offs, d), rows] = np.asarray(A.data)
    return DIA(tuple(int(o) for o in offs), torch.from_numpy(data).to(device), A.shape)


def to_device_format(A: CSR, max_diags: int = 32, dia_fill: float = 2.0,
                     device="cpu"):
    """Pick the execution format for a CSR matrix, on ``device``: DIA when
    the diagonal count is small and the storage waste bounded (stencils),
    padded ELL otherwise (HYB waits for its kernel)."""
    n = A.shape[0]
    try:
        _, _, offs = csr_entry_offsets(A.indptr, A.indices, n)
        if len(offs) <= max_diags and len(offs) * n <= dia_fill * max(A.nnz, 1):
            return csr_to_dia(A, max_diags=max_diags, device=device)
    except ValueError:      # wide rectangular: offsets beyond n-1
        pass
    return csr_to_ell(A, device=device)
