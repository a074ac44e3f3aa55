"""K3: the HYB (band plus remainder) SpMV with its axpby epilogue
(``csrc/hyb_spmv.cu``).

``hyb_spmv(H, x, alpha, beta, z)`` computes ``alpha·(H@x) + beta·z`` for a
HYB matrix in one launch.  On a CUDA tensor it launches the kernel
(float32, float64 or bfloat16, summed in float32 as K1 does; anything else
raises); on a CPU tensor it runs
``hyb_spmv_plain``, the same function in plain PyTorch.  There is no
fallback from one to the other.  Replaces both HYB kernels of
``lssp_tpu/ops/pallas_spmv.py`` (``_dia_spmv_hyb_tc_pallas`` and
``_dia_spmv_hyb_pallas``) and the XLA remainder scatter around them
(``lssp_tpu/ops/spmv.py: _spmv_hyb``).

In bfloat16 K3 takes the band ring (``csrc/band_ring.cuh``) or the
rowwise kernel, chosen and counted as K1's (``ops/dia_spmv.py``).

``hyb_spmm(H, X, alpha, beta, Z)`` is the same on an (n, k) block (the
layout ``ops/spmv.py`` states) in one launch of K3k, the counterpart of
the k-rhs ``custom_vmap`` rules of both HYB kernels; ``hyb_spmm_plain`` is
its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import TilePlan, epilogue, plan_launch, shifted_sum
from lssp_tpu_torch.sparse.types import HYB


def hyb_spmv_plain(H: HYB, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(band·x + remainder·x) + beta·z`` in plain PyTorch: the shifted
    band sum, then ``rem_vals·x[rem_cols]`` added into ``rem_rows``.  ``x``
    may be an (n, k) block (``hyb_spmm_plain``)."""
    y = shifted_sum(H.dia.data, H.dia.offsets, x)
    vals = (H.rem_vals[:, None] if x.ndim == 2 else H.rem_vals).to(y.dtype)
    y = y.index_add(0, H.rem_rows.long(), vals * x[H.rem_cols.long()].to(y.dtype))
    return epilogue(y, alpha, beta, z, torch.promote_types(H.dia.data.dtype, x.dtype))


def _check(H: HYB, x: torch.Tensor, z, block: bool = False) -> None:
    """Raise unless H, x and z are what K3 (``block``: K3k, x an (m, k)
    block) takes."""
    n, m = H.shape
    dt, nrem = x.dtype, H.nnz_rem
    if block:
        k = _kernels.check_block("hyb_spmm X", x, dt, m)
    else:
        _kernels.check_cuda("hyb_spmv x", x, dt, (m,))
    _kernels.check_cuda("hyb_spmv band", H.dia.data, dt, (len(H.dia.offsets), n))
    _kernels.check_cuda("hyb_spmv offsets", H.dia.offsets_t, torch.int32)
    _kernels.check_cuda("hyb_spmv rem_rows", H.rem_rows, torch.int32, (nrem,))
    _kernels.check_cuda("hyb_spmv rem_cols", H.rem_cols, torch.int32, (nrem,))
    _kernels.check_cuda("hyb_spmv rem_vals", H.rem_vals, dt, (nrem,))
    nblocks = -(-n // _kernels.HYB_BLOCK_ROWS)
    _kernels.check_cuda("hyb_spmv rem_block_ptr", H.rem_block_ptr, torch.int32,
                        (nblocks + 1,))
    tensors = [H.dia.data, H.rem_rows, H.rem_cols, H.rem_vals, H.rem_block_ptr]
    if z is not None:
        _kernels.check_cuda("hyb_spmv z", z, dt, (n, k) if block else (n,))
        tensors.append(z)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"hyb_spmv: operand on {t.device}, x on {x.device}")


def hyb_spmv(H: HYB, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             z: Optional[torch.Tensor] = None, plan: Optional[TilePlan] = None) -> torch.Tensor:
    """``y = alpha·(H@x) + beta·z`` (``z`` optional).  CUDA tensors launch
    K3; CPU tensors take ``hyb_spmv_plain``.  A bf16 launch takes the ring
    or the rowwise kernel as for K1 (``ops/dia_spmv.py``: ``plan_launch``,
    ``rem=True``), or as ``plan`` pins it."""
    if x.device.type == "cpu":
        return hyb_spmv_plain(H, x, alpha, beta, z)
    suf = _kernels.kernel_dtype("hyb_spmv x", x)
    _check(H, x, z)
    n, m = H.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if plan is None:
        plan = plan_launch(H.shape, H.dia.offsets, H.dia.data, x, z, y, rem=True)
    lib, p = _kernels.load(), _kernels.ptr
    args = (p(H.dia.data), p(H.dia.offsets_t), len(H.dia.offsets), n, m,
            p(H.rem_rows), p(H.rem_cols), p(H.rem_vals), p(H.rem_block_ptr),
            p(x), float(alpha), float(beta), p(z), p(y))
    if plan.route == "ring":
        status = lib.lssp_hyb_spmv_ring_bf16(*args, *plan.args, _kernels.stream_ptr(x.device))
    else:
        status = getattr(lib, f"lssp_hyb_spmv_{suf}")(*args, _kernels.stream_ptr(x.device))
    _kernels.check_status("hyb_spmv", status)
    _kernels.launched(hyb_spmv, suf, plan.route)
    _kernels.check_nan("hyb_spmv", y)
    return y


hyb_spmv.launches = 0
hyb_spmv.by_dtype = {}
hyb_spmv.by_route = {}


def hyb_spmm_plain(H: HYB, X: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
                   Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(H@X) + beta·Z`` on an (n, k) block in plain PyTorch."""
    if X.ndim != 2:
        raise ValueError(f"hyb_spmm_plain: expected an (n, k) block, got {tuple(X.shape)}")
    return hyb_spmv_plain(H, X, alpha, beta, Z)


def hyb_spmm(H: HYB, X: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Y = alpha·(H@X) + beta·Z`` for an (n, k) block (``Z`` optional).
    CUDA tensors launch K3k once for all k columns; CPU tensors take
    ``hyb_spmm_plain``."""
    if X.device.type == "cpu":
        return hyb_spmm_plain(H, X, alpha, beta, Z)
    suf = _kernels.kernel_dtype("hyb_spmm X", X)
    _check(H, X, Z, block=True)
    n, m = H.shape
    k = X.shape[1]
    Y = torch.empty(n, k, dtype=X.dtype, device=X.device)
    p = _kernels.ptr
    fn = getattr(_kernels.load(), f"lssp_hyb_spmm_{suf}")
    status = fn(p(H.dia.data), p(H.dia.offsets_t), len(H.dia.offsets), n, m, k,
                p(H.rem_rows), p(H.rem_cols), p(H.rem_vals), p(H.rem_block_ptr),
                p(X), float(alpha), float(beta), p(Z), p(Y),
                _kernels.stream_ptr(X.device))
    _kernels.check_status("hyb_spmm", status)
    _kernels.launched(hyb_spmm, suf)
    _kernels.check_nan("hyb_spmm", Y)
    return Y


hyb_spmm.launches = 0
hyb_spmm.by_dtype = {}
