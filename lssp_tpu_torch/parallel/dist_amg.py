"""Distributed classical AMG (``pc="amg"`` over the mesh;
``lssp_tpu/parallel/dist_amg.py``).

Every level's A, P and R = Pᵀ is padded to a shard-divisible row count and
stored as stacked per-shard padded ELL with global column ids.  A product
gathers the whole level vector from every rank's rows (JAX's all-gather;
the rank's flat vector itself without a group) and sums each of the
rank's rows' slots; the coarsest level is the dense solve of
``dist_ops.dense_rows``.  The hierarchy is built whole on the host and
``local`` cuts it to a rank's shards.  Plain torch, as the JAX package
runs it in XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from lssp_tpu_torch.amg.cycle import chebyshev, col, residual
from lssp_tpu_torch.amg.setup import AMGHierarchy
from lssp_tpu_torch.parallel.dist_ops import dense_rows, gather_rows
from lssp_tpu_torch.utils.profile import amg_level, annotate

__all__ = ["DistAMG", "DistAMGLevel", "build_dist_amg", "dist_vcycle"]


@dataclasses.dataclass(frozen=True)
class DistAMGLevel:
    a_cols: Any     # (P, R_l, kA) global (padded) column ids
    a_data: Any
    p_cols: Any     # (P, R_l, kP) into the next level's vector; None on the last
    p_data: Any
    r_cols: Any     # (P, Rc_l, kR) into this level's vector; None on the last
    r_data: Any
    dinv: Any       # (P, R_l)
    n_pad: int      # padded rows of this level
    nc_pad: int     # padded rows of the next level (0 on the last)
    degree: int
    omega: float
    lmax: float
    smoother: str   # "jacobi" | "chebyshev"

    def local(self, p0: int, p1: int) -> "DistAMGLevel":
        """The level's rows of the global shards [p0, p1); the column ids
        stay global."""
        def cut(t):
            return None if t is None else t[p0:p1]
        return dataclasses.replace(
            self, a_cols=cut(self.a_cols), a_data=cut(self.a_data), p_cols=cut(self.p_cols),
            p_data=cut(self.p_data), r_cols=cut(self.r_cols), r_data=cut(self.r_data),
            dinv=cut(self.dinv))


@dataclasses.dataclass(frozen=True)
class DistAMG:
    levels: Tuple[DistAMGLevel, ...]
    coarse_inv: Any     # (nc_pad, nc_pad), whole on every rank (JAX: row shards)

    def local(self, p0: int, p1: int) -> "DistAMG":
        """The hierarchy cut to the global shards [p0, p1) (``_local_state``)."""
        return dataclasses.replace(self, levels=tuple(lev.local(p0, p1) for lev in self.levels))


def _pad_ell(S, nshards: int, dtype):
    """scipy CSR → stacked per-shard padded ELL with global column ids, the
    rows padded with zero rows to a multiple of ``nshards``.  Returns
    (cols (P, R, k), data (P, R, k), n_pad)."""
    S = S.tocsr()
    n = S.shape[0]
    n_pad = -(-n // nshards) * nshards
    R = n_pad // nshards
    rn = np.diff(S.indptr)
    k = max(1, int(rn.max()) if n else 1)
    cols = np.zeros((n_pad, k), dtype=np.int64)
    data = np.zeros((n_pad, k), dtype=dtype)
    valid = np.arange(k)[None, :] < rn[:, None]
    flat = (S.indptr[:-1][:, None] + np.arange(k)[None, :])[valid]
    cols[:n][valid] = S.indices[flat]
    data[:n][valid] = S.data[flat]
    return cols.reshape(nshards, R, k), data.reshape(nshards, R, k), n_pad


def build_dist_amg(hier: AMGHierarchy, nshards: int, dtype=np.float64, degree: int = 2,
                   omega: float = 2.0 / 3.0, smoother: str = "chebyshev",
                   device="cpu") -> DistAMG:
    """The classical hierarchy ``hier`` (``amg/setup.amg_setup``) partitioned
    over ``nshards`` on ``device``."""
    def up(a):
        return None if a is None else torch.from_numpy(a).to(device)

    n_pads = [-(-lev.A.shape[0] // nshards) * nshards for lev in hier.levels]
    levels = []
    for i, lev in enumerate(hier.levels):
        ac, ad, n_pad = _pad_ell(lev.A.astype(dtype), nshards, dtype)
        dinv = np.ones(n_pad, dtype=dtype)
        dinv[:len(lev.dinv)] = lev.dinv.astype(dtype)
        pc_ = pd = rc_ = rd = None
        nc_pad = 0
        if lev.P is not None:
            pc_, pd, _ = _pad_ell(lev.P.astype(dtype), nshards, dtype)
            rc_, rd, _ = _pad_ell(lev.P.T.tocsr().astype(dtype), nshards, dtype)
            nc_pad = n_pads[i + 1]
        levels.append(DistAMGLevel(
            a_cols=up(ac), a_data=up(ad), p_cols=up(pc_), p_data=up(pd), r_cols=up(rc_),
            r_data=up(rd), dinv=up(dinv.reshape(nshards, -1)), n_pad=n_pad, nc_pad=nc_pad,
            degree=degree, omega=omega, lmax=float(lev.lmax), smoother=smoother))
    nc = hier.coarse_inv.shape[0]
    nc_pad = levels[-1].n_pad
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = hier.coarse_inv.astype(dtype)
    return DistAMG(levels=tuple(levels), coarse_inv=up(ci))


def _ag_spmv(cols, data, x, mesh=None):
    """The gathered padded-ELL product: x is the rank's rows of the level
    vector, (n_loc,) or (n_loc, k), all-gathered into the whole vector;
    the result is flat over the rank's padded rows of the operator."""
    x = gather_rows(x, mesh)
    if x.ndim == 2:
        return (data[..., None] * x[cols]).sum(dim=2).reshape(-1, x.shape[1])
    return (data * x[cols]).sum(dim=2).reshape(-1)


def dist_vcycle(h: DistAMG, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """One V-cycle from x = 0 on the rank's flat rows b of the (n_pad,) or
    (n_pad, k) rhs, ``h`` cut to the rank's shards, over ``mesh``'s group:
    the A and R products gather the fine vector, the P product the coarse
    one.  Each visit of level l is the span ``lssp.amg.level.<l>``."""

    def cycle(l, b_l, x_l):
        with annotate(amg_level(l)):
            lev = h.levels[l]
            if l == len(h.levels) - 1:
                return dense_rows(h.coarse_inv, b_l, mesh)

            def Aop(v):
                return _ag_spmv(lev.a_cols, lev.a_data, v, mesh)
            dinv = lev.dinv.reshape(-1)

            def smooth(x):
                if lev.smoother == "jacobi" or lev.lmax <= 0:
                    for _ in range(lev.degree):
                        x = x + lev.omega * col(dinv, b_l) * residual(Aop, x, b_l)
                    return x
                return chebyshev(Aop, dinv, lev.lmax, lev.degree, x, b_l)

            x_l = smooth(x_l)
            rc = _ag_spmv(lev.r_cols, lev.r_data, residual(Aop, x_l, b_l), mesh)
            ec = cycle(l + 1, rc, torch.zeros_like(rc))
            return smooth(x_l + _ag_spmv(lev.p_cols, lev.p_data, ec, mesh))

    return cycle(0, b, torch.zeros_like(b))
