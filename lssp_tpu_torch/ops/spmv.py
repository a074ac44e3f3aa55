"""Sparse matrix–vector products, dispatched on the execution format.

The reference's four mvops entry points (y=βy+αAx, z=βy+αAx, y=αAx, y=Ax;
reference include/mvops.h:9-19) plus ``spmv``.  DIA goes through kernel K1
(``ops/dia_spmv.py``) and HYB through kernel K3 (``ops/hyb_spmv.py``); both
fold the α/β epilogue into the product.  CSR
and ELL are plain PyTorch gathers: on a GPU a gather is a real path, not a
fallback.  Transpose products wait for the methods that need them.
"""
from __future__ import annotations

import torch

from lssp_tpu_torch.ops.dia_spmv import dia_spmv
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv
from lssp_tpu_torch.sparse.types import CSR, DIA, ELL, HYB


def _spmv_csr(A: CSR, x):
    n = A.shape[0]
    rows = torch.repeat_interleave(torch.arange(n, device=x.device),
                                   A.indptr[1:] - A.indptr[:-1])
    y = torch.zeros(n, dtype=torch.promote_types(A.data.dtype, x.dtype), device=x.device)
    return y.index_add_(0, rows, A.data * x[A.indices])


def _spmv_ell(A: ELL, x):
    return (A.data * x[A.cols]).sum(dim=1)


def spmv(A, x):
    """y = A @ x for a DIA, HYB, ELL or device CSR container, or a callable."""
    if isinstance(A, DIA):
        return dia_spmv(A, x)
    if isinstance(A, HYB):
        return hyb_spmv(A, x)
    if isinstance(A, ELL):
        return _spmv_ell(A, x)
    if isinstance(A, CSR):
        if not isinstance(A.data, torch.Tensor):
            raise TypeError("spmv needs a device CSR: call CSR.to(device) first")
        return _spmv_csr(A, x)
    if callable(A):
        return A(x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def mv_amxpby(alpha, A, x, beta, y):
    """beta*y + alpha*A@x (reference mvops.cxx:5-39)."""
    if isinstance(A, DIA):
        return dia_spmv(A, x, alpha=alpha, beta=beta, z=y)
    if isinstance(A, HYB):
        return hyb_spmv(A, x, alpha=alpha, beta=beta, z=y)
    return beta * y + alpha * spmv(A, x)


def mv_amxpbyz(alpha, A, x, beta, y):
    """z = beta*y + alpha*A@x, a new vector (reference mvops.cxx:42-78)."""
    return mv_amxpby(alpha, A, x, beta, y)


def mv_amxy(alpha, A, x):
    """alpha*A@x (reference mvops.cxx:81-115); for DIA and HYB the scale is
    K1's or K3's epilogue, not a second pass over y."""
    if isinstance(A, DIA):
        return dia_spmv(A, x, alpha=alpha)
    if isinstance(A, HYB):
        return hyb_spmv(A, x, alpha=alpha)
    return alpha * spmv(A, x)


def mv_mxy(A, x):
    """A@x (reference mvops.cxx:118-150)."""
    return spmv(A, x)
