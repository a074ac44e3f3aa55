"""Sparse triangular solves for the ILU preconditioners.

Two strategies, as in ``lssp_tpu/ops/trisolve.py``:

1. **Exact, level-scheduled** (``ilu_sweeps=0``; the ``lu`` PC, ``direct``
   and ARMS's coarse solve).  On the host, once: each row's level (longest
   dependency chain); rows of one level are independent.  On the device,
   every apply: a Python loop over the levels, each one gather + row sum +
   scatter over that level's rows.  Two layouts hold a schedule, chosen by
   size (``level_schedule``):

   - ``TriSchedule``, JAX's: every level padded to the factor's widest
     level ``w`` and longest row ``k``, (nlev, w, k) slots (padding points
     at a dummy slot ``n``), kept wherever its slots are within twice the
     factor's nnz;
   - ``CompactSchedule`` past that: the rows in level order as one CSR,
     each level a contiguous slice of rows and of entries, the iterate
     kept in level order, each level's row sums one
     ``torch.segment_reduce`` (one thread a row on CUDA, no atomics: an
     apply repeats bitwise).  Its memory is the factor's nnz plus O(n).
     An LU factor under a fill-reducing ordering has long separator rows
     and wide leaf levels, and JAX's padding then explodes: 3.2e9 slots
     for the L factor of ``laplacian_2d(128)`` under AMD, 1.4e12 at 512²
     (ROADMAP C property 14).  A row sum runs in the stored order, the
     padded one in ``torch.sum``'s: on the CPU the two agree bit for bit
     on rows of at most four entries (a 5- or 7-point stencil's ILU(0))
     and to rounding on longer ones.
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
    """Device level schedule of one triangular factor, JAX's padded layout."""

    rows: Any           # (nlev, w) int64, padded with n
    cols: Any           # (nlev, w, k) int64, padded with n
    vals: Any           # (nlev, w, k), padded with 0
    invdiag: Any        # (n,) 1/diag, or None for unit-diagonal factors
    n: int

    @property
    def nlevels(self) -> int:
        return int(self.rows.shape[0])

    @property
    def slots(self) -> int:
        return int(self.cols.numel())


@dataclasses.dataclass(frozen=True)
class CompactSchedule:
    """Device level schedule of one triangular factor, the rows in level
    order as one CSR.  Level l holds the level-order rows
    ``lev_ptr[l]:lev_ptr[l+1]`` and the entries ``nz_ptr[l]:nz_ptr[l+1]``;
    ``seg[l]`` are that level's row offsets into its own entries (the
    ``segment_reduce`` offsets), None for a level without entries."""

    order: Any          # (n,) int64: the row at each level-order position
    cols: Any           # (nnz,) int64: each entry's column, as a level-order position
    vals: Any           # (nnz,)
    seg: Any            # per level: (rows+1,) int64 offsets, or None
    lev_ptr: tuple      # (nlev+1,) level-order row boundaries (host ints)
    nz_ptr: tuple       # (nlev+1,) entry boundaries (host ints)
    invdiag: Any        # (n,) 1/diag in level order, or None
    n: int

    @property
    def nlevels(self) -> int:
        return len(self.lev_ptr) - 1

    @property
    def slots(self) -> int:
        return int(self.cols.numel())


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


def _strict_levels(T: CSR, lower: bool, diag):
    """(indptr, indices, data) of T's strict triangle, its diagonal (None for
    a unit-diagonal factor) and each row's level."""
    Ls, d, Us = split_ldu(T)
    S = Ls if lower else Us
    if diag is None and np.any(d != 0):
        diag = d
    ip = np.asarray(S.indptr).astype(np.int64)
    idx = np.asarray(S.indices).astype(np.int64)
    return ip, idx, np.asarray(S.data), diag, native.levels(ip, idx, T.shape[0], lower)


def level_schedule(T: CSR, lower: bool = True, diag: Optional[np.ndarray] = None,
                   device="cpu"):
    """Level schedule of a triangular CSR factor, on ``device``.  ``T`` may
    hold its diagonal (split off here); a unit-diagonal factor has none
    stored and ``diag=None``.  JAX's padded ``TriSchedule`` when its nlev·w·k
    slots are at most twice the strict factor's nnz, else the
    ``CompactSchedule``: the choice is made by size alone."""
    n = T.shape[0]
    ip, idx, dat, diag, lev = _strict_levels(T, lower, diag)
    nlev = int(lev.max()) + 1 if n else 1
    w = max(1, int(np.bincount(lev, minlength=nlev).max())) if n else 1
    k = max(1, int((ip[1:] - ip[:-1]).max()) if n else 1)
    build = _padded if nlev * w * k <= 2 * len(idx) else _compact
    return build(ip, idx, dat, diag, lev, n, device)


def _padded(ip, idx, dat, diag, lev, n, device) -> TriSchedule:
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


def _compact(ip, idx, dat, diag, lev, n, device) -> CompactSchedule:
    nlev = int(lev.max()) + 1 if n else 1
    order = np.argsort(lev, kind="stable")
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    rn = (ip[1:] - ip[:-1])[order]
    rptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rn, out=rptr[1:])
    # the entries of the rows in level order, each row's in its stored order
    take = np.repeat(ip[:-1][order] - rptr[:-1], rn) + np.arange(rptr[-1])
    lev_ptr = np.zeros(nlev + 1, dtype=np.int64)
    np.cumsum(np.bincount(lev, minlength=nlev), out=lev_ptr[1:])
    nz_ptr = rptr[lev_ptr]
    seg = tuple(torch.from_numpy(rptr[lev_ptr[l]:lev_ptr[l + 1] + 1] - nz_ptr[l]).to(device)
                if nz_ptr[l + 1] > nz_ptr[l] else None for l in range(nlev))
    invd = None
    if diag is not None:
        invd = torch.from_numpy((1.0 / np.asarray(diag)).astype(dat.dtype)[order]).to(device)
    return CompactSchedule(order=torch.from_numpy(order).to(device),
                           cols=torch.from_numpy(pos[idx[take]]).to(device),
                           vals=torch.from_numpy(np.ascontiguousarray(dat[take])).to(device),
                           seg=seg, lev_ptr=tuple(int(v) for v in lev_ptr),
                           nz_ptr=tuple(int(v) for v in nz_ptr), invdiag=invd, n=n)


def _sweep(sched, b: torch.Tensor) -> torch.Tensor:
    """One exact triangular solve of ``b`` ((n,) or an (n, k) block, solved
    column by column in the same gathers) on either layout."""
    if isinstance(sched, CompactSchedule):
        return _sweep_compact(sched, b)
    return _sweep_padded(sched, b)


def _sweep_padded(sched: TriSchedule, b: torch.Tensor) -> torch.Tensor:
    """A loop over levels, each a gather, a row sum and a scatter into the
    extended iterate (slot n is a dummy that stays 0)."""
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


def _sweep_compact(sched: CompactSchedule, b: torch.Tensor) -> torch.Tensor:
    """A loop over levels on the level-order iterate y: level l's rows are
    y[r0:r1] = (b[order][r0:r1] − segment sums of vals·y[cols]) · 1/diag,
    written in place; x = y scattered back through ``order``."""
    tail = tuple(b.shape[1:])
    bl = b[sched.order]
    vals = sched.vals.to(b.dtype)
    ide = None if sched.invdiag is None else sched.invdiag.to(b.dtype)
    if tail:
        vals = vals[:, None]
        ide = None if ide is None else ide[:, None]
    y = torch.empty_like(bl)
    lp, zp = sched.lev_ptr, sched.nz_ptr
    for lev in range(sched.nlevels):
        r0, r1, e0, e1 = lp[lev], lp[lev + 1], zp[lev], zp[lev + 1]
        out = y[r0:r1]
        if e1 > e0:
            prod = vals[e0:e1] * y[sched.cols[e0:e1]]
            torch.sub(bl[r0:r1], torch.segment_reduce(prod, "sum", offsets=sched.seg[lev],
                                                      axis=0, unsafe=True), out=out)
        else:
            out.copy_(bl[r0:r1])
        if ide is not None:
            out.mul_(ide[r0:r1])
    x = torch.empty_like(y)
    x[sched.order] = y
    return x


def trisolve_lower_unit(sched, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for a unit-diagonal lower L's schedule (reference
    forward solve, solver-tri.cxx:4-24)."""
    return _sweep(sched, b)


def trisolve_upper(sched, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b for an upper U's schedule holding its diagonal
    (reference backward solve, solver-tri.cxx:26-46)."""
    return _sweep(sched, b)


def make_ilu_apply(L: CSR, U: CSR, device="cpu"):
    """Schedules of L (strict lower, unit diagonal) and U (with its
    diagonal) on ``device``, and the closure ``apply(r) -> U⁻¹L⁻¹r``."""
    sl = level_schedule(L, lower=True, device=device)
    su = level_schedule(U, lower=False, device=device)
    return lambda r: ilu_apply(sl, su, r)


def ilu_apply(sched_l, sched_u, r: torch.Tensor):
    """z = U⁻¹ (L⁻¹ r), exact (reference lssp_pc_ilu_solve)."""
    return _sweep(sched_u, _sweep(sched_l, r))


def ilu_apply_t(sched_ut, sched_lt, r: torch.Tensor):
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
