"""Sparse matrix–vector products, dispatched on the execution format.

The reference's four mvops entry points (y=βy+αAx, z=βy+αAx, y=αAx, y=Ax;
reference include/mvops.h:9-19) plus ``spmv``.  DIA goes through kernel K1
(``ops/dia_spmv.py``) and HYB through kernel K3 (``ops/hyb_spmv.py``); both
fold the α/β epilogue into the product.  CSR
and ELL are plain PyTorch gathers: on a GPU a gather is a real path, not a
fallback.  BSR (block-row gather) and BDIA (block-diagonal streams) are
plain PyTorch too, as they are XLA in the JAX package.  ``spmv_t`` (y =
Aᵀx, for the transpose methods bicg, qmr, cgnr and lsqr and the M⁻ᵀ applies)
is plain PyTorch for every format, as it is XLA in the JAX package
(``lssp_tpu/ops/spmv.py:192-258``); it returns ``A.shape[1]`` entries,
also for a non-square DIA or HYB.

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


def _tail(x):
    return tuple(x.shape[1:])


def _spmv_dia_t(A: DIA, x):
    """Σ_d data[d, j − off_d]·x[j − off_d] for each column j: row i of
    diagonal d adds into column i + off_d, one slice add per diagonal in
    order of d (the sums of JAX's ``_spmv_dia_t``, whose extra terms are
    zeros).  Rows whose column falls outside the shape hold stored zeros
    and are skipped, so a tall or wide A gives ``A.shape[1]`` entries."""
    m, ncols = A.shape
    y = x.new_zeros((ncols,) + _tail(x), dtype=torch.promote_types(A.data.dtype, x.dtype))
    for d, off in enumerate(A.offsets):
        lo, hi = max(0, -off), min(m, ncols - off)
        if hi > lo:
            vals = A.data[d, lo:hi]
            y[lo + off:hi + off] += (vals[:, None] if x.ndim == 2 else vals) * x[lo:hi]
    return y


def _spmv_ell_t(A: ELL, x):
    n, k = A.cols.shape
    tail = _tail(x)
    prod = (A.data[:, :, None] * x[:, None] if tail else A.data * x[:, None])
    y = x.new_zeros((A.shape[1],) + tail, dtype=prod.dtype)
    return y.index_add_(0, A.cols.reshape(-1), prod.reshape((n * k,) + tail))


def _spmv_csr_t(A: CSR, x):
    rows = torch.repeat_interleave(torch.arange(A.shape[0], device=x.device),
                                   A.indptr[1:] - A.indptr[:-1], output_size=A.nnz)
    vals = A.data[:, None] if x.ndim == 2 else A.data
    y = x.new_zeros((A.shape[1],) + _tail(x), dtype=torch.promote_types(A.data.dtype, x.dtype))
    return y.index_add_(0, A.indices, vals * x[rows])


def _block_mv_t(blocks, xb):
    """Σ_i blocks[n, i, j]·xb[n, i]: each block transposed times its piece."""
    if xb.ndim == 3:
        return (blocks[..., None] * xb[:, :, None]).sum(dim=1)
    return (blocks * xb[:, :, None]).sum(dim=1)


def _spmv_bsr_t(A: BSR, x):
    bs, nrowb = A.blocksize, A.nrowb
    rows = torch.repeat_interleave(torch.arange(nrowb, device=x.device),
                                   A.indptr[1:] - A.indptr[:-1], output_size=A.nnzb)
    tail = _tail(x)
    prod = _block_mv_t(A.blocks, x.reshape((nrowb, bs) + tail)[rows])
    y = x.new_zeros((A.shape[1] // bs, bs) + tail, dtype=prod.dtype)
    return y.index_add_(0, A.indices, prod).reshape((A.shape[1],) + tail)


def _spmv_bdia_t(A: BDIA, x):
    """Per block diagonal, each block transposed times its block row of x,
    added into block row i + off (JAX's ``_spmv_bdia_t``)."""
    nb, bs = A.nrowb, A.blocksize
    tail = _tail(x)
    xb = x.reshape((nb, bs) + tail)
    y = xb.new_zeros((nb, bs) + tail, dtype=torch.promote_types(A.blocks.dtype, x.dtype))
    for d, off in enumerate(A.offsets):
        lo, hi = max(0, -off), min(nb, nb - off)
        if hi > lo:
            y[lo + off:hi + off] += _block_mv_t(A.blocks[d, lo:hi], xb[lo:hi])
    return y.reshape((A.shape[1],) + tail)


def spmv_t(A, x):
    """y = Aᵀ @ x for a DIA, HYB, ELL, BDIA, device BSR or device CSR
    container; ``x`` (m,) or an (m, k) block, y ``A.shape[1]`` rows.  A
    callable has no transpose here: ``solvers/base.operator_t`` takes its
    ``t_op``."""
    if isinstance(A, DIA):
        return _spmv_dia_t(A, x)
    if isinstance(A, HYB):
        vals = A.rem_vals[:, None] if x.ndim == 2 else A.rem_vals
        return _spmv_dia_t(A.dia, x).index_add_(0, A.rem_cols.long(),
                                                vals * x[A.rem_rows.long()])
    if isinstance(A, ELL):
        return _spmv_ell_t(A, x)
    if isinstance(A, BDIA):
        return _spmv_bdia_t(A, x)
    if isinstance(A, BSR):
        if not isinstance(A.blocks, torch.Tensor):
            raise TypeError("spmv_t needs a device BSR: call BSR.to(device) first")
        return _spmv_bsr_t(A, x)
    if isinstance(A, CSR):
        if not isinstance(A.data, torch.Tensor):
            raise TypeError("spmv_t needs a device CSR: call CSR.to(device) first")
        return _spmv_csr_t(A, x)
    raise TypeError(f"transpose SpMV needs a matrix container, got {type(A)}; "
                    "pass an operator with a .t_op transpose for callable inputs")


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
