"""Distributed structured smoothed-aggregation AMG
(``lssp_tpu/parallel/dist_sa.py``).

Every level is padded to a multiple of P·g (flat aggregates) or aligned by
the grid rules of ``sa_host_levels(shards=P)``, so each shard's rows are
whole aggregates: restriction and prolongation are shard-local reshapes,
and a level's only communication is the halo exchange of its A, B and C
products (``parallel/dist_ops``: a DistDIA level product is kernel K4 on
CUDA) plus the gather that feeds the dense coarse solve.

On the port's mesh a rank's shards are the leading axis of one tensor, so
a level vector is the rank's flat rows (n_l,) (or an (n_l, k) block) and
its shard view (P_loc, R_l).  The hierarchy is built whole on the host,
the JAX package's setup, so the levels are identical to it; ``local``
cuts it to a rank's shards.  Over the ranks of a mesh's group the level
products exchange halos with the neighbouring ranks, the Spike line
smoother all-gathers its interface values and the coarse solve
all-gathers the coarsest vector (``dist_ops.dense_rows``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Tuple

import numpy as np
import torch

from lssp_tpu_torch.amg.aggregate import planned_depth, planned_padded_size
from lssp_tpu_torch.amg.cycle import chebyshev, col, residual
from lssp_tpu_torch.amg.sa import (
    _pad_identity, agg_localize, agg_prolong, agg_restrict, detect_grid, sa_host_levels,
)
from lssp_tpu_torch.ops.tridiag import dist_spike_solve, line_jacobi_sweeps, spike_interface_host
from lssp_tpu_torch.parallel.dist_ops import dense_rows, make_dist_spmv
from lssp_tpu_torch.parallel.partition import partition_matrix
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.utils.profile import amg_level, annotate

__all__ = ["DistSA", "DistSALevel", "build_dist_sa", "dist_sa_vcycle", "planned_depth",
           "planned_padded_size"]


@dataclasses.dataclass(frozen=True)
class DistSALevel:
    A: Any              # DistDIA (banded levels) or DistHYB / DistELL
    B: Any              # prolongator smoother, partitioned, or None
    C: Any              # restriction smoother, partitioned, or None
    dinv: Any           # (P, R_l)
    lmax: float
    g: int
    smoother: str
    degree: int
    n_next: int = 0     # shard-local size of the next level
    agg: Any = None     # shard-local aggregation descriptor (agg_localize)
    tri: Any = None     # line smoother: (dl, d, du, v, w) (P, R_l) and Minv (2P, 2P)
    nshards: int = 1    # the shards held: every global shard, or a rank's after local()

    def ops(self, mesh=None):
        """The level's products (A, B, C) as operators on the rank's flat
        rows, communicating through ``mesh``'s group; built once a mesh."""
        cache = self.__dict__.setdefault("_ops", {})
        if mesh not in cache:
            cache[mesh] = tuple(None if M is None else make_dist_spmv(M, mesh)
                                for M in (self.A, self.B, self.C))
        return cache[mesh]

    def local(self, p0: int, p1: int) -> "DistSALevel":
        """The level cut to the global shards [p0, p1): every per-shard
        field; the line smoother's interface inverse stays whole."""
        def cut(M):
            return None if M is None else M.local(p0, p1)
        tri = None if self.tri is None else \
            tuple(t[p0:p1] for t in self.tri[:5]) + (self.tri[5],)
        return dataclasses.replace(self, A=cut(self.A), B=cut(self.B), C=cut(self.C),
                                   dinv=self.dinv[p0:p1], tri=tri, nshards=p1 - p0)


@dataclasses.dataclass(frozen=True)
class DistSA:
    levels: Tuple[DistSALevel, ...]
    coarse_inv: Any     # (nc, nc) dense inverse, whole on every rank (JAX: row shards)
    n_top: int          # the size the hierarchy was built on (see build_dist_sa)

    def local(self, p0: int, p1: int) -> "DistSA":
        """The hierarchy cut to the global shards [p0, p1) (``_local_state``)."""
        return dataclasses.replace(self, levels=tuple(lev.local(p0, p1) for lev in self.levels))


def _dist_tri_parts(Ah, nshards: int, dtype, device):
    """The line smoother's (dl, d, du) as (P, R) shard slices, with the
    Spike spikes and interface inverse of ``spike_interface_host``.  Lines
    may cross shards: the cross couplings sit in dl[p, 0] / du[p, -1]."""
    nl = Ah.shape[0]
    dl = np.zeros(nl)
    dl[1:] = Ah.diagonal(-1)            # dl[i] = A[i, i-1]
    du = np.zeros(nl)
    du[:-1] = Ah.diagonal(1)            # du[i] = A[i, i+1]
    parts = [a.astype(dtype).reshape(nshards, nl // nshards)
             for a in (dl, np.asarray(Ah.diagonal(0)), du)]
    v, w, Minv = spike_interface_host(*parts)
    return tuple(torch.from_numpy(a).to(device) for a in (*parts, v, w, Minv))


def build_dist_sa(A: CSR, nshards: int, g: int = 4, max_levels: int = 12,
                  coarse_size: int = 512, smoother: str = "chebyshev", degree: int = 2,
                  filter_tol: float = 1e-3, smooth_levels=None, dtype=None, grid=None,
                  device="cpu") -> DistSA:
    """The hierarchy on ``device``.  ``grid``: (gy, gx) row-major dims for
    direction-aware aggregation with shard-aligned groups (None detects,
    False forces flat); grid mode needs gy % P == 0 and pads nothing, flat
    mode pads the fine level to the planned P·gᴸ multiple.  When shard
    alignment stops grid coarsening above 4·coarse_size rows, the flat
    plan is built instead and ``n_top`` says the size it padded to.
    ``smooth_levels=None``: every level in grid mode, 2 flat."""
    dtype = dtype or np.asarray(A.data).dtype
    n = A.shape[0]
    if grid is None:
        grid = detect_grid(A)
    elif grid is False:
        grid = None
    if grid is not None and (grid[0] * grid[1] != n or n % nshards or grid[0] % nshards):
        grid = None
    smooth_levels_arg = smooth_levels
    if smooth_levels is None:
        smooth_levels = max_levels if grid is not None else 2
    if grid is not None:
        levels, Al, _ = sa_host_levels(
            A, g=g, max_levels=max_levels, coarse_size=coarse_size, filter_tol=filter_tol,
            smooth_levels=smooth_levels, grid=grid, shards=nshards)
        if Al.shape[0] > 4 * coarse_size:
            warnings.warn(f"distributed saamg: shard alignment stopped grid coarsening at "
                          f"{Al.shape[0]} rows; falling back to the flat hierarchy "
                          "(consider a shard count dividing the coarse grid)",
                          RuntimeWarning, stacklevel=2)
            grid = None
            if smooth_levels_arg is None:
                smooth_levels = 2
    if grid is None:
        n0 = planned_padded_size(n, nshards, g, coarse_size, max_levels)
        L = planned_depth(n0, g, coarse_size, max_levels)
        Ap = CSR.from_scipy(_pad_identity(A.to_scipy().tocsr(), n0 - n))
        levels, Al, _ = sa_host_levels(
            Ap, g=g, max_levels=L, coarse_size=0, filter_tol=filter_tol,
            smooth_levels=smooth_levels, pad_mult=nshards * g)

    def part(M):
        return None if M is None else partition_matrix(
            CSR.from_scipy(M.astype(dtype)), nshards).to(device)

    dlev = []
    for Ah, B, C, dinv, lmax, n_c, agg in levels:
        nl = Ah.shape[0]
        assert nl % nshards == 0 and (agg is not None or (nl // nshards) % g == 0)
        dlev.append(DistSALevel(
            A=part(Ah), B=part(B), C=part(C),
            dinv=torch.from_numpy(dinv.astype(dtype).reshape(nshards, -1)).to(device),
            lmax=float(lmax), g=g, smoother=smoother, degree=degree,
            n_next=n_c // nshards, agg=agg_localize(agg, nshards),
            tri=_dist_tri_parts(Ah, nshards, dtype, device) if smoother == "line" else None,
            nshards=nshards))
    nc = Al.shape[0]
    nc_pad = -(-nc // nshards) * nshards
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = np.linalg.inv(Al.toarray()).astype(dtype)
    n_top = levels[0][0].shape[0] if levels else Al.shape[0]
    return DistSA(levels=tuple(dlev), coarse_inv=torch.from_numpy(ci).to(device), n_top=n_top)


def shard_local(fn, agg, g: int, n_next: int, P: int, t: torch.Tensor) -> torch.Tensor:
    """``agg_restrict`` / ``agg_prolong`` applied to every one of the P
    shards of the flat t (n,) or (n, k) (P: the shards held, a rank's
    own): the shard axis rides as a trailing batch axis."""
    tail = tuple(t.shape[1:])
    out = fn(agg, g, n_next, t.reshape((P, -1) + tail).movedim(0, 1))
    return out.movedim(1, 0).reshape((-1,) + tail)


def _smooth(lev: DistSALevel, Aop, x, b, mesh=None):
    """Damped line Jacobi (the Spike solve across shards and ranks),
    weighted Jacobi (2/3), or Chebyshev on [0.3, 1.1]·λmax of D⁻¹A
    (``dist_sa_vcycle``'s)."""
    P = lev.nshards
    if lev.smoother == "line" and lev.tri is not None:
        dl, d0, du, vs, ws, mi = lev.tri

        def solve_t(_dl, _d, _du, r):
            tail = tuple(r.shape[1:])
            y = dist_spike_solve(dl, d0, du, vs, ws, mi, r.reshape((P, -1) + tail), mesh)
            return y.reshape(r.shape)
        return line_jacobi_sweeps((dl, d0, du), Aop, x, b, lev.degree, tri_solve=solve_t)
    dinv = lev.dinv.reshape(-1)
    if lev.smoother == "jacobi" or lev.lmax <= 0:
        for _ in range(lev.degree):
            x = x + (2.0 / 3.0) * col(dinv, b) * residual(Aop, x, b)
        return x
    return chebyshev(Aop, dinv, lev.lmax, lev.degree, x, b)


def dist_sa_vcycle(h: DistSA, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """One V-cycle from x = 0 on the rank's flat rows b of the (n_top,) or
    (n_top, k) rhs, ``h`` cut to the rank's shards, over ``mesh``'s group;
    each visit of level l is the span ``lssp.amg.level.<l>``."""

    def cycle(l, b_l, x_l):
        with annotate(amg_level(l)):
            if l == len(h.levels):
                return dense_rows(h.coarse_inv, b_l, mesh)
            lev = h.levels[l]
            Aop, Bop, Cop = lev.ops(mesh)
            x_l = _smooth(lev, Aop, x_l, b_l, mesh)
            r = residual(Aop, x_l, b_l)
            if Cop is not None:
                r = Cop(r)
            rc = shard_local(agg_restrict, lev.agg, lev.g, lev.n_next, lev.nshards, r)
            ec = cycle(l + 1, rc, torch.zeros_like(rc))
            e = shard_local(agg_prolong, lev.agg, lev.g, lev.n_next, lev.nshards, ec)
            if Bop is not None:
                e = Bop(e)
            return _smooth(lev, Aop, x_l + e, b_l, mesh)

    return cycle(0, b, torch.zeros_like(b))
