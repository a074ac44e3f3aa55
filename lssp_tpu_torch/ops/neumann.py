"""K2: the truncated-Neumann ILU apply (``csrc/neumann.cu``).

z ≈ U⁻¹L⁻¹r by k sweeps ``y ← r − Ls·y``, then ``z0 = D⁻¹y``, then k sweeps
``z ← z0 − (D⁻¹Us)·z`` — the same math as the TPU kernel
``lssp_tpu/ops/pallas_neumann.py: _build_call``, whose whole apply sits in
VMEM.  Here each sweep is one launch of ``lssp_neumann_sweep``; the
wrapper ``fused_neumann_apply`` runs the 2k launches, ping-ponging between
two buffers because every sweep reads all of y before writing any of it.

The plan keeps the TPU plan's band/stray split (``split_band``: the up to
48 most-occupied diagonals holding ≥ 2% of n entries each), so the factors
are laid out as in ``lssp_tpu``; strays go in as row-sorted CSR.  The TPU
kernel is fp32 only; this one runs in the plan's dtype (float32 or
float64), and ``fused_neumann_apply`` requires ``r`` in that dtype.

On an (n, k) block (the layout ``ops/spmv.py`` states)
``fused_neumann_apply`` runs ``neumann_block_apply``: the same 2k sweeps
as launches of K2k (``lssp_neumann_sweep_block``), which reads the factors
once per sweep for all k columns, strays included — JAX's k-rhs rule
(``_vmap_safe_apply``) falls back to per-column kernel calls when the
factors have strays; this does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import shifted_sum
from lssp_tpu_torch.sparse.types import CSR, torch_dtype
from lssp_tpu_torch.sparse.utils import split_ldu


@dataclasses.dataclass(frozen=True)
class NeumannFactor:
    """One strict triangular factor: DIA band plus CSR strays."""

    band: Any                   # (ndiag, n)
    offsets: tuple
    offsets_t: Any              # (ndiag,) int32, on band's device
    stray_ptr: Any = None       # (n+1,) int32, or None without strays
    stray_cols: Any = None      # (nstray,) int32
    stray_vals: Any = None      # (nstray,)


@dataclasses.dataclass(frozen=True)
class FusedNeumann:
    """Device state of the apply: the strict lower factor, the strict upper
    factor with rows pre-scaled by 1/diag, 1/diag, and the sweep count."""

    L: NeumannFactor
    U: NeumannFactor
    invdiag: Any                # (n,)
    n: int
    sweeps: int

    @property
    def dtype(self):
        return self.invdiag.dtype


def split_band(S: CSR, n: int, max_diags: int = 48, min_occ: float = 0.02):
    """Band/stray split of a strict factor (host, numpy), the rule of
    ``lssp_tpu/ops/pallas_neumann.py: _split_band``.  Returns (band (nd, n)
    float64, offsets, (stray rows, cols, vals)); a factor with no kept
    diagonal gets one all-zero diagonal at offset 0."""
    ip = np.asarray(S.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(S.indices, dtype=np.int64)
    vals = np.asarray(S.data, dtype=np.float64)
    d = cols - rows
    offs, inv, counts = np.unique(d, return_inverse=True, return_counts=True)
    take = np.argsort(-counts, kind="stable")[:max_diags]
    take = take[counts[take] >= max(1, int(min_occ * n))]
    keep = np.zeros(len(offs), dtype=bool)
    keep[take] = True
    in_band = keep[inv]
    kept = np.sort(offs[keep])
    band = np.zeros((max(len(kept), 1), n), dtype=np.float64)
    if len(kept):
        band[np.searchsorted(kept, d[in_band]), rows[in_band]] = vals[in_band]
    offsets = tuple(int(o) for o in kept) if len(kept) else (0,)
    return band, offsets, (rows[~in_band], cols[~in_band], vals[~in_band])


def _factor(S: CSR, n, max_diags, min_occ, dtype, device) -> NeumannFactor:
    band, offsets, (rows, cols, vals) = split_band(S, n, max_diags, min_occ)
    f = NeumannFactor(band=torch.from_numpy(band).to(device=device, dtype=dtype),
                      offsets=offsets,
                      offsets_t=torch.tensor(offsets, dtype=torch.int32, device=device))
    if len(rows) == 0:
        return f
    if len(rows) >= 2**31:
        raise ValueError(f"{len(rows)} stray entries overflow the int32 CSR")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return dataclasses.replace(
        f, stray_ptr=torch.from_numpy(ptr.astype(np.int32)).to(device),
        stray_cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        stray_vals=torch.from_numpy(vals).to(device=device, dtype=dtype))


def plan_fused_neumann(L: CSR, U: CSR, sweeps: int, max_diags: int = 48,
                       min_occ: float = 0.02, dtype=None, device="cpu") -> FusedNeumann:
    """The apply's state on ``device`` from host factors L (strictly lower,
    unit diagonal implied) and U (upper with the diagonal).  ``dtype``
    (torch) defaults to U's dtype.  The scaled factor and 1/diag are formed
    in float64 and rounded once, as in the TPU plan."""
    n = L.shape[0]
    if dtype is None:
        dtype = torch_dtype(np.asarray(U.data).dtype)
    Ls, _, _ = split_ldu(L)
    _, dU, Us = split_ldu(U)
    dU = np.asarray(dU, dtype=np.float64)
    inv = 1.0 / np.where(dU == 0, 1.0, dU)
    ipu = np.asarray(Us.indptr)
    urows = np.repeat(np.arange(n), ipu[1:] - ipu[:-1])
    Us = dataclasses.replace(Us, data=np.asarray(Us.data) * inv[urows])
    return FusedNeumann(L=_factor(Ls, n, max_diags, min_occ, dtype, device),
                        U=_factor(Us, n, max_diags, min_occ, dtype, device),
                        invdiag=torch.from_numpy(inv).to(device=device, dtype=dtype),
                        n=n, sweeps=int(sweeps))


def _factor_plain(F: NeumannFactor, y: torch.Tensor) -> torch.Tensor:
    """(Ls·y) or ((D⁻¹Us)·y) in plain PyTorch; ``y`` (n,) or (n, k)."""
    acc = shifted_sum(F.band, F.offsets, y)
    if F.stray_ptr is not None:
        n = y.shape[0]
        rows = torch.repeat_interleave(torch.arange(n, device=y.device),
                                       (F.stray_ptr[1:] - F.stray_ptr[:-1]).long(),
                                       output_size=F.stray_cols.shape[0])
        vals = F.stray_vals[:, None] if y.ndim == 2 else F.stray_vals
        acc = acc.index_add(0, rows, vals * y[F.stray_cols.long()])
    return acc


def neumann_apply_plain(plan: FusedNeumann, r: torch.Tensor) -> torch.Tensor:
    """The whole apply in plain PyTorch (the math of K2's 2k sweeps), on
    ``r`` (n,) or an (n, k) block (the math of K2k)."""
    invdiag = plan.invdiag[:, None] if r.ndim == 2 else plan.invdiag
    y = r
    for _ in range(plan.sweeps):
        y = r - _factor_plain(plan.L, y)
    z0 = invdiag * y
    z = z0
    for _ in range(plan.sweeps):
        z = z0 - _factor_plain(plan.U, z)
    return z


def _check_plan(plan: FusedNeumann, device) -> None:
    n, dt = plan.n, plan.dtype
    _kernels.check_cuda("invdiag", plan.invdiag, dt, (n,))
    for name, F in (("L", plan.L), ("U", plan.U)):
        _kernels.check_cuda(f"{name}.band", F.band, dt, (len(F.offsets), n))
        _kernels.check_cuda(f"{name}.offsets", F.offsets_t, torch.int32)
        if F.stray_ptr is not None:
            _kernels.check_cuda(f"{name}.stray_ptr", F.stray_ptr, torch.int32, (n + 1,))
            _kernels.check_cuda(f"{name}.stray_cols", F.stray_cols, torch.int32)
            _kernels.check_cuda(f"{name}.stray_vals", F.stray_vals, dt,
                                F.stray_cols.shape)
        for t in (F.band, F.offsets_t, F.stray_ptr):
            if t is not None and t.device != device:
                raise ValueError(f"plan on {t.device}, r on {device}")


def _run_sweeps(plan: FusedNeumann, r: torch.Tensor, entry: str, sizes, counter):
    """The 2·sweeps launches of ``entry`` (K2, or K2k with ``sizes`` (n,
    k)), ping-ponging between two buffers; each launch adds one to
    ``counter.launches``."""
    if plan.sweeps < 1:
        raise ValueError("fused_neumann_apply needs sweeps >= 1")
    _check_plan(plan, r.device)
    fn = getattr(_kernels.load(), entry)
    stream = _kernels.stream_ptr(r.device)
    p = _kernels.ptr

    def sweep(F: NeumannFactor, y, base, invd, out):
        status = fn(p(F.band), p(F.offsets_t), len(F.offsets), *sizes, p(F.stray_ptr),
                    p(F.stray_cols), p(F.stray_vals), p(y), p(base), p(invd), p(out),
                    stream)
        _kernels.check_status(entry, status)
        counter.launches += 1

    k = plan.sweeps
    z0 = torch.empty_like(r)
    bufs = (torch.empty_like(r), torch.empty_like(r))
    y = r
    for s in range(k):                   # y <- r - Ls y; the last one scales
        last = s == k - 1
        out = z0 if last else bufs[s % 2]
        sweep(plan.L, y, r, plan.invdiag if last else None, out)
        y = out
    for s in range(k):                   # z <- z0 - (D^-1 Us) z
        out = bufs[s % 2]
        sweep(plan.U, y, z0, None, out)
        y = out
    return y


def fused_neumann_apply(plan: FusedNeumann, r: torch.Tensor) -> torch.Tensor:
    """z ≈ U⁻¹L⁻¹r.  CUDA tensors run K2 as 2·sweeps launches (an (n, k)
    block goes to ``neumann_block_apply``, K2k); CPU tensors take
    ``neumann_apply_plain``.  ``r`` must have the plan's dtype."""
    if r.dtype != plan.dtype:
        raise TypeError(f"fused_neumann_apply: r is {r.dtype}, the plan {plan.dtype}")
    if r.device.type == "cpu":
        return neumann_apply_plain(plan, r)
    if r.ndim == 2:
        return neumann_block_apply(plan, r)
    suf = _kernels.kernel_dtype("fused_neumann_apply r", r)
    _kernels.check_cuda("fused_neumann_apply r", r, plan.dtype, (plan.n,))
    return _run_sweeps(plan, r, f"lssp_neumann_sweep_{suf}", (plan.n,), fused_neumann_apply)


fused_neumann_apply.launches = 0


def neumann_block_apply(plan: FusedNeumann, R: torch.Tensor) -> torch.Tensor:
    """Z ≈ U⁻¹L⁻¹R for an (n, k) block.  CUDA tensors run K2k as
    2·sweeps launches, each sweep over all k columns; CPU tensors take
    ``neumann_apply_plain``.  ``R`` must have the plan's dtype."""
    if R.dtype != plan.dtype:
        raise TypeError(f"neumann_block_apply: R is {R.dtype}, the plan {plan.dtype}")
    if R.device.type == "cpu":
        return neumann_apply_plain(plan, R)
    suf = _kernels.kernel_dtype("neumann_block_apply R", R)
    k = _kernels.check_block("neumann_block_apply R", R, plan.dtype, plan.n)
    return _run_sweeps(plan, R, f"lssp_neumann_sweep_block_{suf}", (plan.n, k),
                       neumann_block_apply)


neumann_block_apply.launches = 0
