"""Sparse-matrix containers: frozen dataclasses, no pytree registration.

Host containers (``COO``, ``CSR``, ``BSR``) hold numpy arrays and serve
assembly, conversion and factorization.  Execution containers (``DIA``,
``HYB``, ``ELL``, ``BDIA``) hold torch tensors and move with
``.to(device)``; ``CSR.to(device)`` and ``BSR.to(device)`` give containers
of tensors for the gather SpMV.  Layouts match ``lssp_tpu/sparse/types.py``
so that state carries across as numpy arrays (see ``interop.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of anything np.dtype accepts)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that holds values of the torch ``dtype`` on the host:
    ``numpy_dtype``'s, and float32 for bfloat16, which numpy lacks (every
    bfloat16 value is exact in float32)."""
    return np.dtype(np.float32) if dtype == torch.bfloat16 else numpy_dtype(dtype)


def round_values(a, dtype: torch.dtype) -> np.ndarray:
    """The host array ``a`` rounded to the torch ``dtype``, held in
    ``host_dtype(dtype)``.  bfloat16 is rounded by torch, to nearest even
    through float32 (as ml_dtypes rounds a float64 array), on the way to
    the device's bf16 copy; the other dtypes are a numpy cast."""
    if dtype == torch.bfloat16:
        a32 = np.ascontiguousarray(a, dtype=np.float32)
        return torch.from_numpy(a32).to(torch.bfloat16).float().numpy()
    return np.asarray(a).astype(numpy_dtype(dtype))


def round_to(A, dtype: torch.dtype):
    """A host CSR (or BSR) with its values rounded to the torch ``dtype``
    (``round_values``): the host matrix a ``dtype`` preconditioner is built
    from."""
    vals = A.blocks if isinstance(A, BSR) else A.data
    if dtype != torch.bfloat16 and np.asarray(vals).dtype == numpy_dtype(dtype):
        return A                        # already in that precision: no copy
    if isinstance(A, BSR):
        return dataclasses.replace(A, blocks=round_values(A.blocks, dtype))
    return dataclasses.replace(A, data=round_values(A.data, dtype))


@dataclasses.dataclass(frozen=True)
class COO:
    """Triplet format (reference lssp_mat_coo).  Duplicate (row, col)
    entries are summed on conversion to CSR."""

    row: Any            # (nnz,) int32
    col: Any            # (nnz,) int32
    data: Any           # (nnz,) float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> np.ndarray:
        """Dense array, duplicate entries summed."""
        out = np.zeros(self.shape, dtype=self.dtype)
        np.add.at(out, (np.asarray(self.row), np.asarray(self.col)), np.asarray(self.data))
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix((np.asarray(self.data), (np.asarray(self.row),
                                                      np.asarray(self.col))), shape=self.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row (reference lssp_mat_csr).  ``indptr``:
    (nrows+1,), ``indices``: (nnz,), ``data``: (nnz,); column indices are
    kept sorted within each row.  numpy on the host; ``.to(device)`` gives
    int64-indexed tensors for the gather SpMV."""

    indptr: Any
    indices: Any
    data: Any
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_nnz(self) -> np.ndarray:
        """Stored entries per row."""
        ip = np.asarray(self.indptr)
        return ip[1:] - ip[:-1]

    def todense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((np.asarray(self.data), np.asarray(self.indices),
                              np.asarray(self.indptr)), shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        return CSR(indptr=m.indptr.astype(np.int32),
                   indices=m.indices.astype(np.int32),
                   data=m.data, shape=tuple(m.shape))

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, data=np.asarray(self.data).astype(dtype))

    def to(self, device, dtype=None) -> "CSR":
        """Upload as tensors (int64 indices, the native torch index type)."""
        data = torch.as_tensor(np.asarray(self.data), device=device)
        return CSR(torch.as_tensor(np.asarray(self.indptr, np.int64), device=device),
                   torch.as_tensor(np.asarray(self.indices, np.int64), device=device),
                   data if dtype is None else data.to(dtype), self.shape)


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded ELLPACK: ``cols`` (nrows, k) int64, padded entries point at
    column 0; ``data`` (nrows, k), padded entries 0 — so a gather + row
    sum computes A@x with no mask."""

    cols: Any
    data: Any
    shape: Tuple[int, int]

    @property
    def k(self) -> int:
        """Slots per row."""
        return int(self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device=None, dtype=None) -> "ELL":
        return ELL(self.cols.to(device), self.data.to(device=device, dtype=dtype),
                   self.shape)

    def todense(self) -> np.ndarray:
        n, k = self.data.shape
        out = np.zeros(self.shape, dtype=self.data.cpu().numpy().dtype)
        rows = np.repeat(np.arange(n), k)
        np.add.at(out, (rows, self.cols.cpu().numpy().ravel()),
                  self.data.cpu().numpy().ravel())
        return out


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage, the stencil execution format: ``data[d, i] =
    A[i, i + offsets[d]]`` (row-aligned), out-of-range slots stored as 0.
    ``offsets_t`` is the offsets as a small int32 tensor on ``data``'s
    device, built once and cached on the container for the SpMV kernel."""

    offsets: Tuple[int, ...]
    data: Any                   # (ndiag, nrows) tensor
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @functools.cached_property
    def offsets_t(self) -> torch.Tensor:
        return torch.tensor(self.offsets, dtype=torch.int32, device=self.data.device)

    def to(self, device=None, dtype=None) -> "DIA":
        return DIA(self.offsets, self.data.to(device=device, dtype=dtype), self.shape)

    def todense(self) -> np.ndarray:
        n, m = self.shape
        dat = self.data.cpu().numpy()
        out = np.zeros(self.shape, dtype=dat.dtype)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, m - off))
            out[i, i + off] = dat[d, i]
        return out


@dataclasses.dataclass(frozen=True)
class HYB:
    """Band plus remainder, the execution format for nearly-banded matrices
    (``lssp_tpu/sparse/types.py: HYB``): the densely occupied diagonals as
    a ``DIA``, the other entries as row-sorted COO triplets (CSR order, no
    padding).  ``rem_block_ptr`` (nblocks+1, int32) indexes the triplets by
    blocks of R = ``_kernels.HYB_BLOCK_ROWS`` rows: the entries of rows
    [b·R, (b+1)·R) are [ptr[b], ptr[b+1]).  Kernel K3 (``ops/hyb_spmv.py``) runs one block of
    threads per row block and needs exactly that index.  The TPU's window
    and tile-compact remainder layouts are not carried."""

    dia: DIA
    rem_rows: Any               # (nnz_rem,) int32, ascending
    rem_cols: Any               # (nnz_rem,) int32
    rem_vals: Any               # (nnz_rem,)
    rem_block_ptr: Any          # (ceil(n / HYB_BLOCK_ROWS) + 1,) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def nnz_rem(self) -> int:
        """Stored remainder entries."""
        return int(self.rem_vals.shape[0])

    def to(self, device=None, dtype=None) -> "HYB":
        """Move every tensor to ``device``; ``dtype`` casts the values (band
        and remainder), never the indices."""
        return HYB(self.dia.to(device=device, dtype=dtype), self.rem_rows.to(device),
                   self.rem_cols.to(device), self.rem_vals.to(device=device, dtype=dtype),
                   self.rem_block_ptr.to(device), self.shape)

    def todense(self) -> np.ndarray:
        out = self.dia.todense()
        np.add.at(out, (self.rem_rows.cpu().numpy(), self.rem_cols.cpu().numpy()),
                  self.rem_vals.cpu().numpy())
        return out


@dataclasses.dataclass(frozen=True)
class BSR:
    """Uniform block CSR (reference lssp_mat_bcsr; ``lssp_tpu/sparse/types.py:
    BSR``): ``blocks`` (nnzb, bs, bs) row-major dense blocks, ``indices``
    their block columns, ``shape`` the scalar shape (nrowb·bs, ncolb·bs).
    numpy on the host; ``.to(device)`` gives a BSR of tensors (int64
    indices) for the block-gather product."""

    indptr: Any         # (nrowb+1,)
    indices: Any        # (nnzb,) block-column indices
    blocks: Any         # (nnzb, bs, bs)
    shape: Tuple[int, int]
    blocksize: int

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def nnz(self) -> int:
        return self.nnzb * self.blocksize * self.blocksize

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nrowb(self) -> int:
        return self.shape[0] // self.blocksize

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.bsr_matrix((np.asarray(self.blocks), np.asarray(self.indices),
                              np.asarray(self.indptr)), shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "BSR":
        bs = m.blocksize
        if bs[0] != bs[1]:
            raise ValueError("only square blocks supported")
        return BSR(indptr=m.indptr.astype(np.int32), indices=m.indices.astype(np.int32),
                   blocks=np.asarray(m.data), shape=tuple(m.shape), blocksize=int(bs[0]))

    def todense(self) -> np.ndarray:
        if isinstance(self.blocks, torch.Tensor):
            return BSR(*(a.cpu().numpy() for a in (self.indptr, self.indices, self.blocks)),
                       self.shape, self.blocksize).todense()
        return self.to_scipy().toarray()

    def astype(self, dtype) -> "BSR":
        return dataclasses.replace(self, blocks=np.asarray(self.blocks).astype(dtype))

    def to(self, device=None, dtype=None) -> "BSR":
        """Upload as tensors (int64 indices), or move a device BSR."""
        def index(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)
        return BSR(index(self.indptr), index(self.indices),
                   torch.as_tensor(self.blocks).to(device=device, dtype=dtype),
                   self.shape, self.blocksize)


@dataclasses.dataclass(frozen=True)
class BDIA:
    """Block-diagonal storage, the execution format of block-banded matrices
    (``lssp_tpu/sparse/types.py: BDIA``): ``blocks[d, i] = A_block[i, i +
    offsets[d]]`` (row-aligned, offsets in block units), out-of-range
    blocks 0.  A tensor (ndiag, nrowb, bs, bs) on its device."""

    offsets: Tuple[int, ...]
    blocks: Any
    shape: Tuple[int, int]      # scalar shape
    blocksize: int

    @property
    def nrowb(self) -> int:
        return self.shape[0] // self.blocksize

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def lo(self) -> int:
        """Zero block rows before x that the lowest diagonal reads."""
        return max(0, -min(self.offsets)) if self.offsets else 0

    @property
    def hi(self) -> int:
        """Zero block rows after x that the highest diagonal reads."""
        return max(0, max(self.offsets)) if self.offsets else 0

    @functools.cached_property
    def shift_index(self) -> torch.Tensor:
        """(ndiag, nrowb) int64 on ``blocks``' device: the block row of the
        zero-padded x that block row i of diagonal d reads, lo + off_d + i;
        built once and cached on the container for the product."""
        rows = torch.arange(self.nrowb, device=self.blocks.device)
        offs = torch.tensor(self.offsets, dtype=torch.int64, device=self.blocks.device)
        return self.lo + offs[:, None] + rows

    def to(self, device=None, dtype=None) -> "BDIA":
        return BDIA(self.offsets, self.blocks.to(device=device, dtype=dtype), self.shape,
                    self.blocksize)

    def todense(self) -> np.ndarray:
        nb, bs = self.nrowb, self.blocksize
        blk = self.blocks.cpu().numpy()
        out = np.zeros(self.shape, dtype=blk.dtype)
        for d, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(nb, nb - off)):
                out[i * bs:(i + 1) * bs, (i + off) * bs:(i + off + 1) * bs] = blk[d, i]
        return out
