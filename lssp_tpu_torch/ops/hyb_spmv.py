"""K3: the HYB (band plus remainder) SpMV with its axpby epilogue
(``csrc/hyb_spmv.cu``).

``hyb_spmv(H, x, alpha, beta, z)`` computes ``alpha·(H@x) + beta·z`` for a
HYB matrix in one launch.  On a CUDA tensor it launches the kernel
(float32 or float64; anything else raises); on a CPU tensor it runs
``hyb_spmv_plain``, the same function in plain PyTorch.  There is no
fallback from one to the other.  Replaces both HYB kernels of
``lssp_tpu/ops/pallas_spmv.py`` (``_dia_spmv_hyb_tc_pallas`` and
``_dia_spmv_hyb_pallas``) and the XLA remainder scatter around them
(``lssp_tpu/ops/spmv.py: _spmv_hyb``).
"""
from __future__ import annotations

from typing import Optional

import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import shifted_sum
from lssp_tpu_torch.sparse.types import HYB


def hyb_spmv_plain(H: HYB, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(band·x + remainder·x) + beta·z`` in plain PyTorch: the shifted
    band sum, then ``rem_vals·x[rem_cols]`` added into ``rem_rows``."""
    y = shifted_sum(H.dia.data, H.dia.offsets, x)
    y = y.index_add(0, H.rem_rows.long(), H.rem_vals * x[H.rem_cols.long()])
    if alpha != 1.0:
        y = alpha * y
    if z is not None:
        y = y + beta * z
    return y


def _check(H: HYB, x: torch.Tensor, z) -> None:
    n, m = H.shape
    dt, nrem = x.dtype, H.nnz_rem
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
        _kernels.check_cuda("hyb_spmv z", z, dt, (n,))
        tensors.append(z)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"hyb_spmv: operand on {t.device}, x on {x.device}")


def hyb_spmv(H: HYB, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = alpha·(H@x) + beta·z`` (``z`` optional).  CUDA tensors launch
    K3; CPU tensors take ``hyb_spmv_plain``."""
    if x.device.type == "cpu":
        return hyb_spmv_plain(H, x, alpha, beta, z)
    suf = _kernels.kernel_dtype("hyb_spmv x", x)
    _check(H, x, z)
    n, m = H.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    p = _kernels.ptr
    fn = getattr(_kernels.load(), f"lssp_hyb_spmv_{suf}")
    status = fn(p(H.dia.data), p(H.dia.offsets_t), len(H.dia.offsets), n, m,
                p(H.rem_rows), p(H.rem_cols), p(H.rem_vals), p(H.rem_block_ptr),
                p(x), float(alpha), float(beta), p(z), p(y),
                _kernels.stream_ptr(x.device))
    _kernels.check_status("hyb_spmv", status)
    hyb_spmv.launches += 1
    return y


hyb_spmv.launches = 0
