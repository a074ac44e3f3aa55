"""Relaxation preconditioners: SSOR, SOR, Gauss–Seidel (the reference's
LASPACK and LIS adapter tables, solver-laspack.cxx:29-34,
solver-lis.cxx:8-41; ``lssp_tpu/pc/relax.py``).  Each factors exactly
into a unit-lower L and an upper U,

    M_SSOR = 1/(ω(2−ω)) (D + ωLₛ) D⁻¹ (D + ωUₛ)
           = (I + ωLₛD⁻¹) · [(D + ωUₛ) / (ω(2−ω))]
    M_SOR  = D/ω + Lₛ = (I + ωLₛD⁻¹) · (D/ω),

so ``make_ilu_pc`` applies them: exact level schedules, or on the card
kernel K2 forward and K2 on the transposed plan for M⁻ᵀ.  Gauss–Seidel is
SOR with ω = 1.  SOR's U is its diagonal alone, so its K2 plan's phase-1
factor is one all-zero band (``ops/neumann.split_band``)."""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.config import Defaults
from lssp_tpu_torch.pc.base import register_pc
from lssp_tpu_torch.pc.ilu import make_ilu_pc
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.sparse.utils import split_ldu


def _safe_diag(d):
    """The diagonal with near-zero entries clamped to ±ZERO_DIAG_VALUE, in
    float64 (the factors are formed in float64 and rounded once)."""
    d = np.asarray(d, dtype=np.float64)
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    return np.where(small, np.where(d >= 0, Defaults.ZERO_DIAG_VALUE,
                                    -Defaults.ZERO_DIAG_VALUE), d)


def _as_dtype(dtype, *factors):
    """The factors in the matrix's dtype.  JAX's factors come out float64
    for a float32 matrix (its clamp of the diagonal promotes them), so its
    ``solve_ir`` with ssor, sor or gs stops with a dtype error in the fp32
    inner loop (ROADMAP C property 12); here they keep the matrix's dtype."""
    return [f.astype(dtype) for f in factors]


def _diag_csr(d, shape):
    n = shape[0]
    return CSR(np.arange(n + 1, dtype=np.int32), np.arange(n, dtype=np.int32), d, shape)


def _scale_rows(S: CSR, s: np.ndarray) -> CSR:
    ip = np.asarray(S.indptr)
    rows = np.repeat(np.arange(S.shape[0]), ip[1:] - ip[:-1])
    return CSR(S.indptr, S.indices, np.asarray(S.data) * s[rows], S.shape)


def _scale_cols(S: CSR, s: np.ndarray) -> CSR:
    return CSR(S.indptr, S.indices, np.asarray(S.data) * s[np.asarray(S.indices)], S.shape)


def _append_diag(S: CSR, d: np.ndarray) -> CSR:
    """Upper factor U = diag(d) + S (S strictly upper, columns sorted): the
    diagonal goes first in each row, which keeps the columns sorted."""
    n = S.shape[0]
    ip = np.asarray(S.indptr).astype(np.int64)
    new_ip = np.concatenate([[0], np.cumsum(ip[1:] - ip[:-1] + 1)])
    new_idx = np.zeros(int(new_ip[-1]), dtype=np.int32)
    new_dat = np.zeros(int(new_ip[-1]), dtype=np.asarray(S.data).dtype)
    new_idx[new_ip[:-1]] = np.arange(n, dtype=np.int32)
    new_dat[new_ip[:-1]] = d
    keep = np.ones(int(new_ip[-1]), dtype=bool)
    keep[new_ip[:-1]] = False
    new_idx[keep] = np.asarray(S.indices)
    new_dat[keep] = np.asarray(S.data)
    return CSR(new_ip.astype(np.int32), new_idx, new_dat, S.shape)


@register_pc("ssor")
def setup_ssor(A, opts, device):
    if not 0.0 < opts.omega < 2.0:
        raise ValueError(f"SSOR requires 0 < omega < 2, got {opts.omega}")
    Ls, d, Us = split_ldu(A)
    d = _safe_diag(d)
    w = opts.omega
    # (D + ωLₛ)D⁻¹ = I + ωLₛD⁻¹: a column scaling (a row scaling agrees only
    # for a constant diagonal)
    L = _scale_cols(Ls, w / d)
    U = _append_diag(_scale_rows(Us, np.full_like(d, w / (w * (2 - w)))), d / (w * (2 - w)))
    L, U = _as_dtype(np.asarray(A.data).dtype, L, U)
    return make_ilu_pc(L, U, f"ssor(w={w})", opts.ilu_sweeps, transpose=opts.transpose,
                       device=device)


def _setup_sor(A, opts, omega, device):
    if omega <= 0.0:
        raise ValueError(f"SOR requires omega > 0, got {omega}")
    Ls, d, _ = split_ldu(A)
    d = _safe_diag(d)
    L = _scale_cols(Ls, omega / d)                  # ωLₛD⁻¹
    U = _diag_csr(d / omega, A.shape)               # D/ω
    L, U = _as_dtype(np.asarray(A.data).dtype, L, U)
    return make_ilu_pc(L, U, f"sor(w={omega})", opts.ilu_sweeps, transpose=opts.transpose,
                       device=device)


@register_pc("sor")
def setup_sor(A, opts, device):
    return _setup_sor(A, opts, opts.omega, device)


@register_pc("gs")
def setup_gs(A, opts, device):
    """Forward Gauss–Seidel: SOR with ω = 1."""
    return _setup_sor(A, opts, 1.0, device)
