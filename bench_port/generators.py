"""The benchmark's own copies of the test matrices, frozen here so that a
change to the program's generators cannot change what is measured.

Each returns a ``scipy.sparse.csr_array`` (fp64, int32 indices, sorted,
no duplicates), assembled row by row from the stencil as the program's
``sparse/generators.py`` does.  The plain reference (``reference.py``)
and the program's input are both made from it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _assemble(n, parts):
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    A = sp.coo_array((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sort_indices()
    A.indptr = A.indptr.astype(np.int32)
    A.indices = A.indices.astype(np.int32)
    return A


def laplacian_3d(N: int) -> sp.csr_array:
    """3-D 7-point Poisson on an N³ grid: diagonal 6, neighbours -1,
    row-major (i, j, k) ordering."""
    n = N * N * N
    idx = np.arange(n, dtype=np.int64)
    i, rem = idx // (N * N), idx % (N * N)
    j, k = rem // N, rem % N
    parts = []
    for mask, off, v in ((i > 0, -N * N, -1.0), (j > 0, -N, -1.0), (k > 0, -1, -1.0),
                         (None, 0, 6.0), (k < N - 1, 1, -1.0), (j < N - 1, N, -1.0),
                         (i < N - 1, N * N, -1.0)):
        r = idx if mask is None else idx[mask]
        parts.append((r, r + off, np.full(r.shape[0], v)))
    return _assemble(n, parts)


def anisotropic_poisson_2d(N: int, epsilon: float) -> sp.csr_array:
    """2-D anisotropic Poisson -(u_xx + eps·u_yy) on an N² grid: diagonal
    2 + 2·eps, -1 along a row of the grid, -eps across rows."""
    n = N * N
    idx = np.arange(n, dtype=np.int64)
    i, j = idx // N, idx % N
    parts = []
    for mask, off, v in ((i > 0, -N, -epsilon), (j > 0, -1, -1.0),
                         (None, 0, 2.0 + 2.0 * epsilon), (j < N - 1, 1, -1.0),
                         (i < N - 1, N, -epsilon)):
        r = idx if mask is None else idx[mask]
        parts.append((r, r + off, np.full(r.shape[0], v)))
    return _assemble(n, parts)


GENERATORS = {"laplacian_3d": laplacian_3d, "anisotropic_poisson_2d": anisotropic_poisson_2d}


def build(config: dict) -> sp.csr_array:
    """The matrix of a configuration: its ``generator`` called with the
    configuration's keys of the same names as the generator's arguments."""
    fn = GENERATORS[config["generator"]]
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    return fn(**{a: config[a] for a in args})


def structure(A: sp.csr_array) -> dict:
    """What the byte formulas need of a matrix: rows, and its diagonals
    (all, below and above the main one)."""
    coo = A.tocoo()
    offsets = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    return {"n": int(A.shape[0]), "nnz": int(A.nnz), "nd": int(offsets.size),
            "nd_lower": int((offsets < 0).sum()), "nd_upper": int((offsets > 0).sum())}
