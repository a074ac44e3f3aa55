"""Sparse triangular solves for the ILU preconditioners.

Two strategies, as in ``lssp_tpu/ops/trisolve.py``:

1. **Exact, level-scheduled** (``ilu_sweeps=0``).  On the host, once: each
   row's level (longest dependency chain); rows of one level are
   independent.  On the device, every apply: a Python loop over the levels,
   each one gather + row sum + scatter over that level's rows (padded to a
   rectangle; padding points at a dummy slot ``n``).
2. **Truncated Neumann** (``ilu_sweeps=k>0``).  For unit-lower L = I + Ls,
   k sweeps of ``y ← r − Ls·y`` give the degree-k truncation of L⁻¹; the
   same for U after scaling its rows by 1/diag.  The preconditioner's
   apply runs as kernel K2 (``ops/neumann.py``), its M⁻ᵀ apply as K2 on
   the transposed plan (``plan_fused_neumann_t``).  ``make_neumann_tri``,
   ``neumann_ilu_apply`` and ``neumann_ilu_apply_t`` here are the same
   series as one SpMV (or ``spmv_t``) per sweep, the counterparts of the
   JAX functions of those names: the independent reference of both plans
   in the tests, on no device path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from lssp_tpu_torch import native
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.sparse.utils import split_ldu


@dataclasses.dataclass(frozen=True)
class TriSchedule:
    """Device level schedule of one triangular factor."""

    rows: Any           # (nlev, w) int64, padded with n
    cols: Any           # (nlev, w, k) int64, padded with n
    vals: Any           # (nlev, w, k), padded with 0
    invdiag: Any        # (n,) 1/diag, or None for unit-diagonal factors
    n: int

    @property
    def nlevels(self) -> int:
        return int(self.rows.shape[0])


def default_ilu_sweeps(device) -> int:
    """The ilu_sweeps=None resolution: 6 Neumann sweeps on CUDA (the K2
    path, as the TPU default), exact level scheduling on the CPU."""
    return 6 if torch.device(device).type == "cuda" else 0


def neumann_exact_depth(tris) -> int:
    """Dependency depth over strict triangular factors given as (indptr,
    indices, n, lower) tuples: the sweep count at which the finite Neumann
    series of every factor is exact (the ilu_sweeps=-1 contract)."""
    depth = 1
    for ip, idx, n, lower in tris:
        lev = native.levels(np.asarray(ip, np.int64), np.asarray(idx, np.int64), n, lower)
        depth = max(depth, int(lev.max()) + 1 if len(lev) else 1)
    return depth


def level_schedule(T: CSR, lower: bool = True, diag: Optional[np.ndarray] = None,
                   device="cpu") -> TriSchedule:
    """Level schedule of a triangular CSR factor, on ``device``.  ``T`` may
    hold its diagonal (split off here); a unit-diagonal factor has none
    stored and ``diag=None``."""
    n = T.shape[0]
    Ls, d, Us = split_ldu(T)
    S = Ls if lower else Us
    if diag is None and np.any(d != 0):
        diag = d
    ip = np.asarray(S.indptr).astype(np.int64)
    idx = np.asarray(S.indices).astype(np.int64)
    dat = np.asarray(S.data)

    lev = native.levels(ip, idx, n, lower)
    nlev = int(lev.max()) + 1 if n else 1
    order = np.argsort(lev, kind="stable")
    counts = np.bincount(lev, minlength=nlev)
    w = max(1, int(counts.max()))
    k = max(1, int((ip[1:] - ip[:-1]).max()) if n else 1)

    rows = np.full((nlev, w), n, dtype=np.int64)
    cols = np.full((nlev, w, k), n, dtype=np.int64)
    vals = np.zeros((nlev, w, k), dtype=dat.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slots = np.arange(n, dtype=np.int64) - starts[lev[order]]
    rows[lev[order], slots] = order
    rn = ip[1:] - ip[:-1]
    valid = np.arange(k)[None, :] < rn[:, None]
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[valid]
    ell_cols = np.full((n, k), n, dtype=np.int64)
    ell_vals = np.zeros((n, k), dtype=dat.dtype)
    ell_cols[valid] = idx[flat]
    ell_vals[valid] = dat[flat]
    cols[lev[order], slots] = ell_cols[order]
    vals[lev[order], slots] = ell_vals[order]

    invd = None
    if diag is not None:
        invd = torch.from_numpy((1.0 / np.asarray(diag)).astype(dat.dtype)).to(device)
    return TriSchedule(rows=torch.from_numpy(rows).to(device),
                       cols=torch.from_numpy(cols).to(device),
                       vals=torch.from_numpy(vals).to(device), invdiag=invd, n=n)


def _sweep(sched: TriSchedule, b: torch.Tensor) -> torch.Tensor:
    """One exact triangular solve: a loop over levels, each a gather, a
    row sum and a scatter into the extended iterate (slot n is a dummy that
    stays 0).  ``b`` is (n,) or an (n, k) block, solved column by column
    in the same gathers."""
    n = sched.n
    tail = tuple(b.shape[1:])
    be = torch.cat([b, b.new_zeros((1,) + tail)])
    ide = None
    if sched.invdiag is not None:
        ide = torch.cat([sched.invdiag.to(b.dtype), b.new_ones(1)])
        if tail:
            ide = ide[:, None]
    vals = sched.vals.to(b.dtype)
    if tail:
        vals = vals[..., None]
    xe = b.new_zeros((n + 1,) + tail)
    for lev in range(sched.nlevels):
        rows = sched.rows[lev]
        s = be[rows] - (vals[lev] * xe[sched.cols[lev]]).sum(dim=1)
        if ide is not None:
            s = s * ide[rows]
        xe[rows] = s
    return xe[:n]


def ilu_apply(sched_l: TriSchedule, sched_u: TriSchedule, r: torch.Tensor):
    """z = U⁻¹ (L⁻¹ r), exact (reference lssp_pc_ilu_solve)."""
    return _sweep(sched_u, _sweep(sched_l, r))


def ilu_apply_t(sched_ut: TriSchedule, sched_lt: TriSchedule, r: torch.Tensor):
    """z = M⁻ᵀ r = L⁻ᵀ (U⁻ᵀ r) for M = LU, from the schedules of Uᵀ (lower,
    with the diagonal) and Lᵀ (upper, unit diagonal)."""
    return _sweep(sched_lt, _sweep(sched_ut, r))


def ilu_transpose_schedules(L: CSR, U: CSR, device="cpu"):
    """Level schedules of the transposed factors (host, once)."""
    from lssp_tpu_torch.sparse.utils import transpose
    return (level_schedule(transpose(U), lower=True, device=device),
            level_schedule(transpose(L), lower=False, device=device))


@dataclasses.dataclass(frozen=True)
class NeumannTri:
    """State for the SpMV-composed Neumann apply."""

    Ls: Any         # strict lower factor, execution format (DIA/ELL)
    Us: Any         # strict upper factor scaled by 1/diag, execution format
    invdiag: Any    # (n,)
    sweeps: int


def make_neumann_tri(L: CSR, U: CSR, sweeps: int = 6, device="cpu") -> NeumannTri:
    """Neumann state from L (strictly lower, unit diagonal) and U (upper with
    the diagonal): U⁻¹ = (I + D⁻¹Us)⁻¹ D⁻¹, so the strict upper rows are
    scaled by 1/diag once."""
    from lssp_tpu_torch.sparse.convert import to_device_format
    _, d, Us = split_ldu(U)
    d = np.where(d == 0, 1.0, d)
    inv = (1.0 / d).astype(np.asarray(U.data).dtype)
    ip = np.asarray(Us.indptr)
    rows = np.repeat(np.arange(U.shape[0]), ip[1:] - ip[:-1])
    Us_scaled = CSR(Us.indptr, Us.indices, np.asarray(Us.data) * inv[rows], Us.shape)
    return NeumannTri(Ls=to_device_format(L, device=device),
                      Us=to_device_format(Us_scaled, device=device),
                      invdiag=torch.from_numpy(inv).to(device), sweeps=sweeps)


def neumann_ilu_apply(state: NeumannTri, r: torch.Tensor) -> torch.Tensor:
    """z ≈ U⁻¹ L⁻¹ r by truncated Neumann sweeps, each one SpMV."""
    from lssp_tpu_torch.ops.spmv import spmv
    y = r
    for _ in range(state.sweeps):
        y = r - spmv(state.Ls, y)
    zr = state.invdiag * y
    z = zr
    for _ in range(state.sweeps):
        z = zr - spmv(state.Us, z)
    return z


def neumann_ilu_apply_t(state: NeumannTri, r: torch.Tensor) -> torch.Tensor:
    """z ≈ M⁻ᵀr = L⁻ᵀU⁻ᵀr by transposed Neumann sweeps on ``spmv_t`` (JAX's
    ``neumann_ilu_apply_t``): with ``Us`` stored as D⁻¹Us, U⁻ᵀ =
    D⁻¹(I + UsᵀD⁻¹)⁻¹, and L⁻ᵀ = (I + Lsᵀ)⁻¹."""
    from lssp_tpu_torch.ops.spmv import spmv_t
    w = r
    for _ in range(state.sweeps):
        w = r - spmv_t(state.Us, w)
    zr = state.invdiag * w
    z = zr
    for _ in range(state.sweeps):
        z = zr - spmv_t(state.Ls, z)
    return z
