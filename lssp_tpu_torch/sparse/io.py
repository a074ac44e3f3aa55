"""MatrixMarket I/O (``lssp_tpu/sparse/io.py``): read through scipy, which
also opens ``.gz`` files, and write coordinate files, gzip-compressed for a
``.gz`` path."""
from __future__ import annotations

import gzip

import numpy as np

from lssp_tpu_torch.sparse.types import CSR


def read_matrix_market(path: str) -> CSR:
    """A host CSR from a MatrixMarket file (symmetric storage expanded,
    duplicates summed, columns sorted by scipy's conversion)."""
    import scipy.io as sio
    return CSR.from_scipy(sio.mmread(path, spmatrix=False).tocsr())


def write_matrix_market(path: str, A: CSR, comment: str = "") -> None:
    """Write a CSR as a MatrixMarket coordinate file (general, real, 17
    significant digits, so a read gives the same values back)."""
    ip = np.asarray(A.indptr)
    rows = np.repeat(np.arange(A.shape[0]), ip[1:] - ip[:-1])
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
        f.writelines(f"{r + 1} {c + 1} {v:.17g}\n"
                     for r, c, v in zip(rows, np.asarray(A.indices), np.asarray(A.data)))
