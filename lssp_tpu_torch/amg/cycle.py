"""The classical AMG cycle on the device (``lssp_tpu/amg/cycle.py``).

The host hierarchy (``amg/setup.py``) is converted once into execution
formats on the device: each level's A by ``to_device_format`` (DIA, HYB or
ELL, so a DIA level runs kernel K1 and a HYB level K3 on CUDA), P and R as
ELL gathers.  The cycle is a Python recursion over the levels with
pointwise smoothers only (weighted Jacobi or Chebyshev preconditioned by
D⁻¹), so every device operation is an SpMV or elementwise work.

Every function takes a vector (n,) or an (n, k) block (the layout of
``ops/spmv.py``), each column cycled as its own vector, as JAX runs the
cycle under ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from lssp_tpu_torch.amg.setup import AMGHierarchy, amg_setup
from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.ops.spmv import mv_amxpby, spmv
from lssp_tpu_torch.sparse.convert import csr_to_ell, to_device_format
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.utils.profile import amg_level, annotate


@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: Any          # device-format matrix (DIA, HYB or ELL)
    P: Any          # ELL (n_f, n_c), None on the coarsest level
    R: Any          # ELL (n_c, n_f), None on the coarsest level
    dinv: Any       # (n,)
    lmax: float     # λ_max(D⁻¹A) estimate
    smoother: str
    degree: int     # smoothing steps / Chebyshev degree
    omega: float    # Jacobi damping


@dataclasses.dataclass(frozen=True)
class DeviceAMG:
    levels: Tuple[DeviceLevel, ...]
    coarse_inv: Any
    cycles: int     # cycles per application
    gamma: int = 1  # 1 = V-cycle, 2 = W-cycle


def col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row vector broadcast over the columns of an (n, k) ``like``."""
    return v[:, None] if like.ndim == 2 else v


def residual(A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b − A·x, one launch of the SpMV kernel with its epilogue on a DIA or
    HYB level."""
    return mv_amxpby(-1.0, A, x, 1.0, b)


def build_device_amg(hier: AMGHierarchy, dtype=np.float64, smoother: str = "chebyshev",
                     degree: int = 2, omega: float = 2.0 / 3.0, cycles: int = 1,
                     gamma: int = 1, device=None) -> DeviceAMG:
    device = resolve_device(device)
    levels = []
    for lev in hier.levels:
        Ad = to_device_format(CSR.from_scipy(lev.A.astype(dtype)), device=device)
        if lev.P is not None:
            P = csr_to_ell(CSR.from_scipy(lev.P.astype(dtype)), device=device)
            R = csr_to_ell(CSR.from_scipy(lev.P.T.tocsr().astype(dtype)), device=device)
        else:
            P = R = None
        levels.append(DeviceLevel(
            A=Ad, P=P, R=R, dinv=torch.from_numpy(lev.dinv.astype(dtype)).to(device),
            lmax=float(lev.lmax), smoother=smoother, degree=degree, omega=omega))
    return DeviceAMG(levels=tuple(levels),
                     coarse_inv=torch.from_numpy(hier.coarse_inv.astype(dtype)).to(device),
                     cycles=cycles, gamma=gamma)


def chebyshev(A, dinv, lmax: float, degree: int, x, b):
    """Chebyshev smoothing of D⁻¹A on [0.3, 1.1]·λmax (hypre's
    cheby_fraction = 0.3: the coarse grid owns the modes below 0.3·λmax);
    shared with the structured cycles (``amg/sa.py``)."""
    ub = 1.1 * lmax
    lb = 0.3 * lmax
    theta = (ub + lb) / 2.0
    delta = (ub - lb) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    dv = col(dinv, b)
    r = dv * residual(A, x, b)
    d = r / theta
    for _ in range(degree):
        x = x + d
        r = r - dv * spmv(A, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def _smooth(lev: DeviceLevel, x, b):
    if lev.degree <= 0:
        return x
    if lev.smoother == "jacobi":
        for _ in range(lev.degree):
            x = x + lev.omega * col(lev.dinv, b) * residual(lev.A, x, b)
        return x
    if lev.smoother == "l1jacobi":
        # dinv is 1/diag; the l1 damping is folded into a fixed 0.5
        for _ in range(lev.degree):
            x = x + 0.5 * col(lev.dinv, b) * residual(lev.A, x, b)
        return x
    return chebyshev(lev.A, lev.dinv, lev.lmax, lev.degree, x, b)


def _cycle_at(h: DeviceAMG, l: int, b_l, x_l):
    """One cycle starting at level ``l`` (0 = finest); the visit is the
    span ``lssp.amg.level.<l>``."""
    with annotate(amg_level(l)):
        lev = h.levels[l]
        if l == len(h.levels) - 1:
            return h.coarse_inv @ b_l
        x_l = _smooth(lev, x_l, b_l)
        rc = spmv(lev.R, residual(lev.A, x_l, b_l))
        ec = _cycle_at(h, l + 1, rc, torch.zeros_like(rc))
        for _ in range(h.gamma - 1):
            # W-cycle: revisit the coarse hierarchy warm-started
            ec = _cycle_at(h, l + 1, rc, ec)
        x_l = x_l + spmv(lev.P, ec)
        return _smooth(lev, x_l, b_l)


def vcycle(h: DeviceAMG, b, x=None):
    """``h.cycles`` cycles from x (0 by default: the PC application)."""
    if x is None:
        x = torch.zeros_like(b)
    for _ in range(h.cycles):
        x = _cycle_at(h, 0, b, x)
    return x


def fmg_initial(h: DeviceAMG, b):
    """Full-multigrid initial guess: restrict b down the hierarchy, solve the
    coarsest exactly, interpolate up with one cycle per level."""
    bs = [b]
    for l in range(len(h.levels) - 1):
        bs.append(spmv(h.levels[l].R, bs[-1]))
    x = h.coarse_inv @ bs[-1]
    for l in range(len(h.levels) - 2, -1, -1):
        x = spmv(h.levels[l].P, x)
        x = _cycle_at(h, l, bs[l], x)
    return x


def amg_solve(A: CSR, b, x0=None, rtol: float = 1e-7, atol: float = 1e-7,
              maxit: int = 100, theta: float = 0.25, smoother: str = "chebyshev",
              degree: int = 2, dtype=np.float64, fmg: bool = False, device=None):
    """Standalone AMG solver: the stationary cycle iteration x += V(b − Ax)
    until ‖b − Ax‖ ≤ max(rtol·‖r0‖, atol) or ``maxit`` cycles (the JAX
    package's route off the TPU).  ``fmg=True`` starts from the
    full-multigrid guess.  ``device``: as in ``solve``.  Returns (x, {"nits",
    "residual", "complexity"})."""
    from lssp_tpu_torch.solvers.base import norm      # solvers imports amg
    device = resolve_device(device, b)
    hier = amg_setup(A, theta=theta)
    h = build_device_amg(hier, dtype=dtype, smoother=smoother, degree=degree,
                         device=device)
    tdtype = h.coarse_inv.dtype
    b = torch.as_tensor(b).to(device=device, dtype=tdtype)
    x = (torch.zeros_like(b) if x0 is None
         else torch.as_tensor(x0).to(device=device, dtype=tdtype))
    if fmg and x0 is None:
        x = fmg_initial(h, b)
    A0 = h.levels[0].A
    r = residual(A0, x, b)
    res = norm(r).item()
    tol = max(rtol * res, atol)
    it = 0
    while it < maxit and res > tol:
        x = x + vcycle(h, r)
        r = residual(A0, x, b)
        res = norm(r).item()
        it += 1
    return x, {"nits": it, "residual": res, "complexity": hier.complexity()}
