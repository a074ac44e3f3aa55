"""K1: the DIA stencil SpMV with its axpby epilogue (``csrc/dia_spmv.cu``),
and K1k, its k-rhs form.

``dia_spmv(A, x, alpha, beta, z)`` computes ``alpha·(A@x) + beta·z`` for a
DIA matrix.  On a CUDA tensor it launches the kernel (float32 or float64;
anything else raises); on a CPU tensor it runs ``dia_spmv_plain``, the same
function in plain PyTorch.  There is no fallback from one to the other.
Replaces ``lssp_tpu/ops/pallas_spmv.py: _dia_spmv_pallas``.

``dia_spmm(A, X, alpha, beta, Z)`` is the same on an (n, k) block (the
layout ``ops/spmv.py`` states) in one launch of K1k, the counterpart of the
k-rhs ``custom_vmap`` rule of ``_vmap_safe_kernel``; ``dia_spmm_plain`` is
its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.sparse.types import DIA


def shifted_sum(data: torch.Tensor, offsets, y: torch.Tensor) -> torch.Tensor:
    """Σ_d data[d, i]·y[i + off_d] with out-of-range reads as 0 — the DIA
    product in plain PyTorch (shared with the plain Neumann sweep).  ``y``
    is (m,) or an (m, k) block; a block's rows are shifted and each
    diagonal is broadcast over its k columns."""
    n = data.shape[1]
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets) + n - y.shape[0]) if offsets else 0
    block = y.ndim == 2
    yp = F.pad(y, (0, 0, lo, hi) if block else (lo, hi))
    acc = torch.zeros((n,) + tuple(y.shape[1:]), dtype=torch.promote_types(data.dtype, y.dtype),
                      device=y.device)
    for d, off in enumerate(offsets):
        acc = acc + (data[d, :, None] if block else data[d]) * yp[lo + off:lo + off + n]
    return acc


def dia_spmv_plain(data: torch.Tensor, offsets, x: torch.Tensor, alpha: float = 1.0,
                   beta: float = 0.0, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(Σ_d data[d]·shift(x, off_d)) + beta·z`` in plain PyTorch."""
    y = shifted_sum(data, offsets, x)
    if alpha != 1.0:
        y = alpha * y
    if z is not None:
        y = y + beta * z
    return y


def dia_spmv(A: DIA, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = alpha·(A@x) + beta·z`` (``z`` optional).  CUDA tensors launch
    K1; CPU tensors take ``dia_spmv_plain``."""
    if x.device.type == "cpu":
        return dia_spmv_plain(A.data, A.offsets, x, alpha, beta, z)
    n, m = A.shape
    suf = _kernels.kernel_dtype("dia_spmv x", x)
    _kernels.check_cuda("dia_spmv data", A.data, x.dtype, (len(A.offsets), n))
    _kernels.check_cuda("dia_spmv x", x, x.dtype, (m,))
    if A.data.device != x.device:
        raise ValueError(f"dia_spmv: data on {A.data.device}, x on {x.device}")
    if z is not None:
        _kernels.check_cuda("dia_spmv z", z, x.dtype, (n,))
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = getattr(_kernels.load(), f"lssp_dia_spmv_{suf}")
    status = fn(_kernels.ptr(A.data), _kernels.ptr(A.offsets_t), len(A.offsets), n, m,
                _kernels.ptr(x), float(alpha), float(beta), _kernels.ptr(z),
                _kernels.ptr(y), _kernels.stream_ptr(x.device))
    _kernels.check_status("dia_spmv", status)
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_spmm_plain(data: torch.Tensor, offsets, X: torch.Tensor, alpha: float = 1.0,
                   beta: float = 0.0, Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(A@X) + beta·Z`` on an (n, k) block in plain PyTorch: one
    shifted row slice of X per diagonal, the diagonal broadcast over the
    columns (the math of JAX's shifted-stream SpMM rule)."""
    if X.ndim != 2:
        raise ValueError(f"dia_spmm_plain: expected an (n, k) block, got {tuple(X.shape)}")
    return dia_spmv_plain(data, offsets, X, alpha, beta, Z)


def dia_spmm(A: DIA, X: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Y = alpha·(A@X) + beta·Z`` for an (n, k) block (``Z`` optional).
    CUDA tensors launch K1k once for all k columns; CPU tensors take
    ``dia_spmm_plain``."""
    if X.device.type == "cpu":
        return dia_spmm_plain(A.data, A.offsets, X, alpha, beta, Z)
    n, m = A.shape
    suf = _kernels.kernel_dtype("dia_spmm X", X)
    k = _kernels.check_block("dia_spmm X", X, X.dtype, m)
    _kernels.check_cuda("dia_spmm data", A.data, X.dtype, (len(A.offsets), n))
    if A.data.device != X.device:
        raise ValueError(f"dia_spmm: data on {A.data.device}, X on {X.device}")
    if Z is not None:
        _kernels.check_cuda("dia_spmm Z", Z, X.dtype, (n, k))
    Y = torch.empty(n, k, dtype=X.dtype, device=X.device)
    fn = getattr(_kernels.load(), f"lssp_dia_spmm_{suf}")
    status = fn(_kernels.ptr(A.data), _kernels.ptr(A.offsets_t), len(A.offsets), n, m, k,
                _kernels.ptr(X), float(alpha), float(beta), _kernels.ptr(Z),
                _kernels.ptr(Y), _kernels.stream_ptr(X.device))
    _kernels.check_status("dia_spmm", status)
    dia_spmm.launches += 1
    return Y


dia_spmm.launches = 0
