"""K4: the per-shard DIA SpMV of the distributed solve, all shards in one
launch (``csrc/dia_spmv_ext.cu``).

``dia_spmv_ext(data, offsets, x_ext, alpha, beta, z)`` computes, for every
shard p of a (P, ndiag, R) band,

    y[p, i] = alpha·Σ_d data[p, d, i]·x_ext[p, lo + i + off_d] + beta·z[p, i]

where ``x_ext`` (P, R + lo + hi) carries each shard's halos, so every read
is in range.  On a CUDA tensor it launches the kernel (float32, float64
or bfloat16, summed in float32 as K1 does; anything else raises); on a CPU tensor it runs ``dia_spmv_ext_plain``, the
same function in plain PyTorch.  There is no fallback from one to the
other.  Replaces ``lssp_tpu/ops/pallas_spmv.py: _dia_spmv_pallas``
(``prepadded=True``, entry ``dia_spmv_pallas_ext``).

``dia_spmm_ext`` is the same on a (P, R + lo + hi, k) block in one launch
of K4k, the counterpart of the k-rhs ``custom_vmap`` rule of
``_vmap_safe_ext_kernel``; ``dia_spmm_ext_plain`` is its plain version.

Each wrapper counts its launches by shape in ``by_shape``: (ndiag, lo,
hi, R, P, element bytes) for K4, with k after them for K4k.  One K4
launch may be a product (every band of the matrix) or one Neumann sweep
(a factor's bands), so the bytes a window's launches must move are read
from this mix.
"""
from __future__ import annotations

from typing import Optional

import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import acc_dtype, epilogue


def _halos(offsets):
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    return lo, hi


def dia_spmv_ext_plain(data: torch.Tensor, offsets, x_ext: torch.Tensor,
                       alpha: float = 1.0, beta: float = 0.0,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product in plain PyTorch: one slice of ``x_ext`` per
    diagonal, summed over the (P, ·) tensors in offset order.  ``x_ext``
    may be a (P, R + lo + hi, k) block (``dia_spmm_ext_plain``)."""
    P, _, R = data.shape
    lo, _ = _halos(offsets)
    block = x_ext.ndim == 3
    dtype = torch.promote_types(data.dtype, x_ext.dtype)
    acc_dt = acc_dtype(dtype)
    data, x_ext = data.to(acc_dt), x_ext.to(acc_dt)
    y = torch.zeros((P, R) + tuple(x_ext.shape[2:]), dtype=acc_dt, device=x_ext.device)
    for d, off in enumerate(offsets):
        y = y + (data[:, d, :, None] if block else data[:, d]) * x_ext[:, lo + off:lo + off + R]
    return epilogue(y, alpha, beta, z, dtype)


def dia_spmv_ext(data: torch.Tensor, offsets, x_ext: torch.Tensor, alpha: float = 1.0,
                 beta: float = 0.0, z: Optional[torch.Tensor] = None,
                 offsets_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = alpha·(band·x_ext) + beta·z`` over all shards, (P, R).  CUDA
    tensors launch K4; CPU tensors take ``dia_spmv_ext_plain``.
    ``offsets_t``: the offsets as an int32 tensor on the device (built
    here when not given)."""
    if x_ext.device.type == "cpu":
        return dia_spmv_ext_plain(data, offsets, x_ext, alpha, beta, z)
    P, ndiag, R = data.shape
    lo, hi = _halos(offsets)
    dt = x_ext.dtype
    suf = _kernels.kernel_dtype("dia_spmv_ext x_ext", x_ext)
    if offsets_t is None:
        offsets_t = torch.tensor(offsets, dtype=torch.int32, device=x_ext.device)
    _kernels.check_cuda("dia_spmv_ext data", data, dt, (P, len(offsets), R))
    _kernels.check_cuda("dia_spmv_ext offsets", offsets_t, torch.int32, (ndiag,))
    _kernels.check_cuda("dia_spmv_ext x_ext", x_ext, dt, (P, R + lo + hi))
    tensors = [data, offsets_t]
    if z is not None:
        _kernels.check_cuda("dia_spmv_ext z", z, dt, (P, R))
        tensors.append(z)
    for t in tensors:
        if t.device != x_ext.device:
            raise ValueError(f"dia_spmv_ext: operand on {t.device}, x_ext on {x_ext.device}")
    y = torch.empty(P, R, dtype=dt, device=x_ext.device)
    p = _kernels.ptr
    fn = getattr(_kernels.load(), f"lssp_dia_spmv_ext_{suf}")
    status = fn(p(data), p(offsets_t), ndiag, P, R, R + lo + hi, lo, p(x_ext),
                float(alpha), float(beta), p(z), p(y), _kernels.stream_ptr(x_ext.device))
    _kernels.check_status("dia_spmv_ext", status)
    _kernels.launched(dia_spmv_ext, suf, shape=(ndiag, lo, hi, R, P, x_ext.element_size()))
    _kernels.check_nan("dia_spmv_ext", y)
    return y


dia_spmv_ext.launches = 0
dia_spmv_ext.by_dtype = {}
dia_spmv_ext.by_shape = {}


def dia_spmm_ext_plain(data: torch.Tensor, offsets, x_ext: torch.Tensor,
                       alpha: float = 1.0, beta: float = 0.0,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(band·x_ext) + beta·z`` on a (P, R + lo + hi, k) block in
    plain PyTorch, (P, R, k)."""
    if x_ext.ndim != 3:
        raise ValueError(f"dia_spmm_ext_plain: expected a (P, R + lo + hi, k) block, "
                         f"got {tuple(x_ext.shape)}")
    return dia_spmv_ext_plain(data, offsets, x_ext, alpha, beta, z)


def dia_spmm_ext(data: torch.Tensor, offsets, x_ext: torch.Tensor, alpha: float = 1.0,
                 beta: float = 0.0, z: Optional[torch.Tensor] = None,
                 offsets_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = alpha·(band·x_ext) + beta·z`` over all shards and k columns,
    (P, R, k).  CUDA tensors launch K4k once; CPU tensors take
    ``dia_spmm_ext_plain``."""
    if x_ext.device.type == "cpu":
        return dia_spmm_ext_plain(data, offsets, x_ext, alpha, beta, z)
    P, ndiag, R = data.shape
    lo, hi = _halos(offsets)
    dt = x_ext.dtype
    suf = _kernels.kernel_dtype("dia_spmm_ext x_ext", x_ext)
    if x_ext.ndim != 3:
        raise ValueError(f"dia_spmm_ext: expected a (P, R + lo + hi, k) block, "
                         f"got {tuple(x_ext.shape)}")
    k = int(x_ext.shape[2])
    if offsets_t is None:
        offsets_t = torch.tensor(offsets, dtype=torch.int32, device=x_ext.device)
    _kernels.check_cuda("dia_spmm_ext data", data, dt, (P, len(offsets), R))
    _kernels.check_cuda("dia_spmm_ext offsets", offsets_t, torch.int32, (ndiag,))
    _kernels.check_cuda("dia_spmm_ext x_ext", x_ext, dt, (P, R + lo + hi, k))
    tensors = [data, offsets_t]
    if z is not None:
        _kernels.check_cuda("dia_spmm_ext z", z, dt, (P, R, k))
        tensors.append(z)
    for t in tensors:
        if t.device != x_ext.device:
            raise ValueError(f"dia_spmm_ext: operand on {t.device}, x_ext on {x_ext.device}")
    y = torch.empty(P, R, k, dtype=dt, device=x_ext.device)
    p = _kernels.ptr
    fn = getattr(_kernels.load(), f"lssp_dia_spmm_ext_{suf}")
    status = fn(p(data), p(offsets_t), ndiag, P, R, R + lo + hi, lo, k, p(x_ext),
                float(alpha), float(beta), p(z), p(y), _kernels.stream_ptr(x_ext.device))
    _kernels.check_status("dia_spmm_ext", status)
    _kernels.launched(dia_spmm_ext, suf, shape=(ndiag, lo, hi, R, P, x_ext.element_size(), k))
    _kernels.check_nan("dia_spmm_ext", y)
    return y


dia_spmm_ext.launches = 0
dia_spmm_ext.by_dtype = {}
dia_spmm_ext.by_shape = {}
