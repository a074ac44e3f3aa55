"""Sparse matrix–vector products, dispatched on the execution format.

The reference's four mvops entry points (y=βy+αAx, z=βy+αAx, y=αAx, y=Ax;
reference include/mvops.h:9-19) plus ``spmv``.  DIA goes through kernel K1
(``ops/dia_spmv.py``) and HYB through kernel K3 (``ops/hyb_spmv.py``); both
fold the α/β epilogue into the product.  CSR
and ELL are plain PyTorch gathers: on a GPU a gather is a real path, not a
fallback.  BSR (block-row gather) and BDIA (block-diagonal streams) are
plain PyTorch too, as they are XLA in the JAX package.  Transpose products
wait for the methods that need them.

**Block layout.**  Every entry point also takes a block of k vectors, the
multi-rhs path's operand.  A block is an (n, k) tensor, one column per
right-hand side (as JAX's ``solve_multi`` takes B), stored row-major and
contiguous: element (i, c) at offset i·k + c, so the k values of one row
are adjacent.  A distributed block is the view (P, R, k) of the same
memory, the shard axis still dim 0.  The k-rhs kernels K1k-K4k
(``dia_spmm``, ``hyb_spmm``, ``neumann_block_apply``, ``dia_spmm_ext``)
take exactly this layout and check it at entry: a non-contiguous block
raises and is never copied.  DIA blocks go to K1k and HYB blocks to K3k,
one launch for all k columns; ELL, BSR and device CSR gather on the
block, and BDIA shifts it.
A 1-column block gives the vector path's values.
"""
from __future__ import annotations

import torch

from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmv
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmv
from lssp_tpu_torch.sparse.types import BDIA, BSR, CSR, DIA, ELL, HYB


def _spmv_csr(A: CSR, x):
    n = A.shape[0]
    rows = torch.repeat_interleave(torch.arange(n, device=x.device),
                                   A.indptr[1:] - A.indptr[:-1])
    y = torch.zeros((n,) + tuple(x.shape[1:]),
                    dtype=torch.promote_types(A.data.dtype, x.dtype), device=x.device)
    vals = A.data[:, None] if x.ndim == 2 else A.data
    return y.index_add_(0, rows, vals * x[A.indices])


def _spmv_ell(A: ELL, x):
    if x.ndim == 2:
        return (A.data[:, :, None] * x[A.cols]).sum(dim=1)
    return (A.data * x[A.cols]).sum(dim=1)


def _block_mv(blocks, xb):
    """Σ_j blocks[n, i, j]·xb[n, j] for blocks (N, bs, bs) and xb (N, bs) or
    (N, bs, k): one multiply and one sum, no batched GEMM of tiny blocks."""
    if xb.ndim == 3:
        return (blocks[..., None] * xb[:, None]).sum(dim=2)
    return (blocks * xb[:, None, :]).sum(dim=2)


def _spmv_bsr(A: BSR, x):
    """The block-row gather product (JAX's ``_spmv_bsr``): gather the block
    columns' pieces of x, one block product each, scatter-add per block row."""
    bs, nrowb = A.blocksize, A.nrowb
    rows = torch.repeat_interleave(torch.arange(nrowb, device=x.device),
                                   A.indptr[1:] - A.indptr[:-1], output_size=A.nnzb)
    tail = tuple(x.shape[1:])
    prod = _block_mv(A.blocks, x.reshape((A.shape[1] // bs, bs) + tail)[A.indices])
    y = torch.zeros((nrowb, bs) + tail, dtype=prod.dtype, device=x.device)
    return y.index_add_(0, rows, prod).reshape((A.shape[0],) + tail)


def _spmv_bdia(A: BDIA, x):
    """The block-diagonal product (JAX's ``_spmv_bdia``): every diagonal's
    block-shifted piece of the zero-padded x in one gather, then one
    multiply and one sum over the diagonals and the block columns."""
    nb, bs = A.nrowb, A.blocksize
    tail = tuple(x.shape[1:])
    xb = x.reshape((nb, bs) + tail)
    xp = torch.cat([xb.new_zeros((A.lo, bs) + tail), xb, xb.new_zeros((A.hi, bs) + tail)])
    xs = xp[A.shift_index]                                  # (ndiag, nb, bs) + tail
    blocks = A.blocks[..., None] if tail else A.blocks
    return (blocks * xs[:, :, None]).sum(dim=(0, 3)).reshape((A.shape[0],) + tail)


def _kernel_product(A, x, alpha=1.0, beta=0.0, y=None):
    """The DIA or HYB product through its kernel (the block form for an
    (n, k) x), or None for other formats."""
    if isinstance(A, DIA):
        fn = dia_spmm if x.ndim == 2 else dia_spmv
    elif isinstance(A, HYB):
        fn = hyb_spmm if x.ndim == 2 else hyb_spmv
    else:
        return None
    return fn(A, x, alpha, beta, y)


def spmv(A, x):
    """y = A @ x for a DIA, HYB, ELL, BDIA, device BSR or device CSR
    container, or a callable; ``x`` (n,) or an (n, k) block."""
    y = _kernel_product(A, x)
    if y is not None:
        return y
    if isinstance(A, ELL):
        return _spmv_ell(A, x)
    if isinstance(A, BDIA):
        return _spmv_bdia(A, x)
    if isinstance(A, BSR):
        if not isinstance(A.blocks, torch.Tensor):
            raise TypeError("spmv needs a device BSR: call BSR.to(device) first")
        return _spmv_bsr(A, x)
    if isinstance(A, CSR):
        if not isinstance(A.data, torch.Tensor):
            raise TypeError("spmv needs a device CSR: call CSR.to(device) first")
        return _spmv_csr(A, x)
    if callable(A):
        return A(x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def mv_amxpby(alpha, A, x, beta, y):
    """beta*y + alpha*A@x (reference mvops.cxx:5-39)."""
    out = _kernel_product(A, x, alpha, beta, y)
    return beta * y + alpha * spmv(A, x) if out is None else out


def mv_amxpbyz(alpha, A, x, beta, y):
    """z = beta*y + alpha*A@x, a new vector (reference mvops.cxx:42-78)."""
    return mv_amxpby(alpha, A, x, beta, y)


def mv_amxy(alpha, A, x):
    """alpha*A@x (reference mvops.cxx:81-115); for DIA and HYB the scale is
    K1's or K3's epilogue, not a second pass over y."""
    out = _kernel_product(A, x, alpha)
    return alpha * spmv(A, x) if out is None else out


def mv_mxy(A, x):
    """A@x (reference mvops.cxx:118-150)."""
    return spmv(A, x)
