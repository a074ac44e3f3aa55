"""Host-side format conversions (numpy), run once at assembly time.

Same rules as ``lssp_tpu/sparse/convert.py``: COO→CSR is a counting sort
that sums duplicates (reference matrix-utils.cxx:324-380), CSR↔BSR moves
whole bs×bs blocks; DIA, BDIA and ELL are the execution formats, built on
the host and handed out as tensors on the requested device.  ``to_device_format`` tries DIA, then HYB (band plus
remainder), then ELL, as the JAX package does off the TPU.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.sparse.types import BDIA, BSR, COO, CSR, DIA, ELL, HYB


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def csr_entry_offsets(indptr, indices, n):
    """Per-entry diagonal offsets (col − row) and their sorted unique set,
    by a counting pass, for a matrix of ``n`` rows.  Returns ``(rows, d,
    offs)``, int32 when 2n < 2³¹.  Offsets must lie in [-(n-1), n-1]: a
    square or tall matrix always qualifies, a wide one whose columns pass
    its row count raises ``ValueError``."""
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


def csr_to_coo(A: CSR) -> COO:
    """CSR → COO triplets in CSR order (copies of the indices and values)."""
    ip = np.asarray(A.indptr)
    row = np.repeat(np.arange(A.shape[0], dtype=np.int32), ip[1:] - ip[:-1])
    return COO(row, np.asarray(A.indices).copy(), np.asarray(A.data).copy(), A.shape)


def csr_to_bsr(A: CSR, blocksize: int) -> BSR:
    """CSR→uniform-block BSR (reference csr→bcsr, matrix-utils.cxx:62-162):
    every entry lands in its bs×bs block, blocks stored dense (explicit
    zeros), row-major.  Raises ``ValueError`` when a dimension is not a
    multiple of ``blocksize``."""
    n, m = A.shape
    bs = int(blocksize)
    if n % bs or m % bs:
        raise ValueError(f"matrix shape {A.shape} not divisible by blocksize {bs}")
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    keys = (rows // bs) * (m // bs) + cols // bs
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq = np.empty(len(keys_s), dtype=bool)
    if len(keys_s):
        uniq[0] = True
        np.not_equal(keys_s[1:], keys_s[:-1], out=uniq[1:])
    blk_ids = np.cumsum(uniq) - 1 if len(keys_s) else np.array([], np.int64)
    nnzb = int(blk_ids[-1] + 1) if len(keys_s) else 0
    blocks = np.zeros((nnzb, bs, bs), dtype=dat.dtype)
    blocks[blk_ids, rows[order] % bs, cols[order] % bs] = dat[order]
    ukeys = keys_s[uniq]
    indptr = np.zeros(n // bs + 1, dtype=np.int64)
    np.add.at(indptr, ukeys // (m // bs) + 1, 1)
    return BSR(np.cumsum(indptr).astype(np.int32), (ukeys % (m // bs)).astype(np.int32),
               blocks, (n, m), bs)


def bsr_to_csr(A: BSR, prune: bool = True) -> CSR:
    """BSR→CSR; explicit zeros inside blocks are dropped when ``prune``."""
    bs, nrowb = A.blocksize, A.nrowb
    ip = np.asarray(A.indptr).astype(np.int64)
    bcols = np.asarray(A.indices).astype(np.int64)
    blocks = np.asarray(A.blocks)
    brows = np.repeat(np.arange(nrowb, dtype=np.int64), ip[1:] - ip[:-1])
    nnzb = blocks.shape[0]
    r = np.broadcast_to(brows[:, None, None] * bs + np.arange(bs)[None, :, None],
                        (nnzb, bs, bs)).ravel()
    c = np.broadcast_to(bcols[:, None, None] * bs + np.arange(bs)[None, None, :],
                        (nnzb, bs, bs)).ravel()
    v = blocks.ravel()
    if prune:
        keep = v != 0
        r, c, v = r[keep], c[keep], v[keep]
    return coo_to_csr(COO(r.astype(np.int32), c.astype(np.int32), v, A.shape),
                      sum_duplicates=False)


def bsr_to_bdia(A: BSR, max_diags: int = 32, fill: float = 2.0, device="cpu") -> BDIA:
    """BSR→block-diagonal storage on ``device``.  Raises ``ValueError`` when
    the block-diagonal count passes ``max_diags`` or the padding passes
    ``fill`` times the stored blocks (callers keep a gather format then)."""
    nb, bs = A.nrowb, A.blocksize
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(nb, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    offs = np.unique(cols - rows)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} block diagonals > {max_diags}")
    if len(offs) * nb > fill * max(A.nnzb, 1):
        raise ValueError("block-diagonal padding waste too large")
    blocks = np.zeros((len(offs), nb, bs, bs), dtype=np.asarray(A.blocks).dtype)
    blocks[np.searchsorted(offs, cols - rows), rows] = np.asarray(A.blocks)
    return BDIA(tuple(int(o) for o in offs), torch.from_numpy(blocks).to(device), A.shape, bs)


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


def _select_band(counts: np.ndarray, n: int, max_diags: int,
                 min_occ: float) -> np.ndarray:
    """The band rule shared by ``csr_to_hyb`` and ``band_occupancy`` (and so
    RCM's acceptance test): the up-to-``max_diags`` most-occupied diagonals,
    each holding at least max(min_occ·n, 16) entries.  A stable sort, so
    ties keep the JAX package's choice.  Returns indices into ``counts``."""
    order = np.argsort(-counts, kind="stable")
    take = order[:max_diags]
    return take[counts[take] >= max(min_occ * n, 16.0)]


def band_occupancy(A: CSR, max_diags: int = 256, min_occ: float = 0.02) -> float:
    """Fraction of nnz a HYB split would stream as DIA diagonals."""
    n = A.shape[0]
    _, d, offs = csr_entry_offsets(A.indptr, A.indices, n)
    if len(d) == 0:
        return 0.0
    counts = np.bincount(np.searchsorted(offs, d), minlength=len(offs))
    take = _select_band(counts, n, max_diags, min_occ)
    return float(counts[take].sum()) / max(A.nnz, 1)


class BandCoverageError(ValueError):
    """The band of a HYB split would cover too little of the nnz."""


def hyb_from_parts(dia: DIA, rows, cols, vals, shape) -> HYB:
    """A HYB from its band and its remainder triplets (numpy, row-sorted),
    with the remainder on the band's device.  Builds
    the per-block index K3 reads (``_kernels.HYB_BLOCK_ROWS`` rows a
    block) and rejects triplets the kernel cannot take: unsorted rows,
    indices out of range, or more than 2³¹−1 entries or rows."""
    n, m = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if not (len(rows) == len(cols) == len(vals)):
        raise ValueError("remainder rows, cols and vals differ in length")
    if max(n, m, len(rows)) >= 2**31:
        raise ValueError("HYB indexes rows, columns and remainder entries in int32")
    if len(rows) and (np.any(np.diff(rows) < 0) or rows[0] < 0 or rows[-1] >= n
                      or cols.min() < 0 or cols.max() >= m):
        raise ValueError("remainder triplets must be row-sorted and inside the shape")
    R = _kernels.HYB_BLOCK_ROWS
    starts = np.arange(-(-n // R) + 1, dtype=np.int64) * R
    ptr = np.searchsorted(rows, starts, side="left")
    dev = dia.data.device

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)
    return HYB(dia, up(rows, np.int32), up(cols, np.int32), up(vals), up(ptr, np.int32),
               (int(n), int(m)))


def csr_to_hyb(A: CSR, max_diags: int = 256, min_occ: float = 0.02,
               min_cover: float = 0.5, device="cpu") -> HYB:
    """CSR→band plus remainder on ``device``: the diagonals ``_select_band``
    keeps stream as DIA, the other entries stay as row-sorted triplets.
    Raises ``BandCoverageError`` (a ``ValueError``) when the band would
    cover less than ``min_cover`` of the nnz (ELL is then no worse)."""
    n, _ = A.shape
    rows, d_all, offs = csr_entry_offsets(A.indptr, A.indices, n)
    cols = np.asarray(A.indices)
    dat = np.asarray(A.data)
    all_idx = np.searchsorted(offs, d_all)
    counts = np.bincount(all_idx, minlength=len(offs))
    take = _select_band(counts, n, max_diags, min_occ)
    if len(take) == 0 or counts[take].sum() < min_cover * max(A.nnz, 1):
        raise BandCoverageError(f"band coverage {counts[take].sum() / max(A.nnz, 1):.2f} below "
                         f"min_cover={min_cover}; use ELL")
    keep = np.zeros(len(offs), dtype=bool)
    keep[take] = True
    in_band = keep[all_idx]
    kept = offs[keep].astype(np.int64)
    band = np.zeros((len(kept), n), dtype=dat.dtype)
    band[np.searchsorted(kept, d_all[in_band]), rows[in_band]] = dat[in_band]
    dia = DIA(tuple(int(o) for o in kept), torch.from_numpy(band).to(device), A.shape)
    out = ~in_band
    return hyb_from_parts(dia, rows[out], cols[out], dat[out], A.shape)


def to_device_format(A: CSR, max_diags: int = 32, dia_fill: float = 2.0,
                     hyb_diags: int = 256, device=None):
    """Pick the execution format for a CSR matrix, on ``device``: DIA when
    the diagonal count is small and the storage waste bounded (stencils),
    HYB when a dominant band holds most entries, padded ELL otherwise.
    ``device`` follows ``config.resolve_device``: the current CUDA device
    unless one is named, and an error without a CUDA device.

    A rectangular matrix (lsqr) follows the same rule over its rows: a tall
    one gets the format JAX gives it (the regularised least-squares system
    [L; 0.1·I] becomes HYB, its band the two blocks' diagonals), and K1 and
    K3 bound every read of x by the column count; a wide one whose offsets
    pass its row count goes to ELL.  ``ops/spmv.spmv_t`` returns
    ``A.shape[1]`` entries for each of them."""
    device = resolve_device(device)
    n = A.shape[0]
    try:
        _, _, offs = csr_entry_offsets(A.indptr, A.indices, n)
    except ValueError:      # wide rectangular: offsets beyond n-1, no band
        return csr_to_ell(A, device=device)
    if len(offs) <= max_diags and len(offs) * n <= dia_fill * max(A.nnz, 1):
        return csr_to_dia(A, max_diags=max_diags, device=device)
    try:
        return csr_to_hyb(A, max_diags=hyb_diags, device=device)
    except BandCoverageError:
        return csr_to_ell(A, device=device)
