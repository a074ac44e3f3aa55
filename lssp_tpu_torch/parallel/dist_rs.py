"""Distributed classical AMG (``pc="rsamg"`` over the mesh;
``lssp_tpu/parallel/dist_rs.py``).

The classical hierarchy of ``amg/rs.py`` runs through the distributed
saamg cycle by one identity:

    P·ec = P̂·broadcast(ec),    Pᵀ·r = pairsum(P̂ᵀ·r)

``broadcast`` and ``pairsum`` are the shard-local pair reshapes of
``dist_sa`` (its ``agg`` descriptors), and P̂ (n × n, banded) places each
interpolation weight P[i, c] at the fine column of c's parity-matching
group member, so every coarse offset is a constant column offset and P̂
partitions onto the DistDIA halo path like any banded operator.  A level
is therefore a ``DistSALevel`` with B = P̂ and C = P̂ᵀ, run by
``dist_sa_vcycle``.

Pair groups must not straddle the shard cuts, so an axis coarsens only
when ``axis_feasible``; coarsening stops early when none does, and the
dense coarse solve takes the rest.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lssp_tpu_torch import native
from lssp_tpu_torch.amg.rs import (
    _axis_strengths, axis_parity, cap_offsets, coarse_dims, detect_grid3, elect_cpoints,
    group_index,
)
from lssp_tpu_torch.amg.setup import direct_interpolation, lambda_est, strength_graph
from lssp_tpu_torch.parallel.dist_sa import DistSA, DistSALevel
from lssp_tpu_torch.parallel.partition import partition_matrix
from lssp_tpu_torch.sparse.types import CSR

__all__ = ["axis_feasible", "build_dist_rs", "phat_from_p"]


def axis_feasible(dims, axis: int, P: int) -> bool:
    """Pair coarsening along ``axis`` keeps the groups inside one row shard
    (rows are (z, y, x) row-major, a shard n/P consecutive rows): the axis
    extent is even, and for x whole (nz·ny) rows a shard, for y also an
    even count of them, for z whole planes in even counts."""
    nz, ny, nx = dims
    if dims[axis] % 2:
        return False
    if axis == 2:
        return nx > 1 and (nz * ny) % P == 0
    if axis == 1:
        return ny > 1 and (nz * ny) % P == 0 and ((nz * ny) // P) % 2 == 0
    return nz > 1 and nz % P == 0 and (nz // P) % 2 == 0


def _local_agg(dims, axis: int, P: int):
    """The shard-local ``sa.py`` descriptor of the pair mode along ``axis``."""
    nz, ny, nx = dims
    if axis == 2:
        return ("x", 2, (nz * ny) // P, nx, -(-nx // 2))
    if axis == 1:
        gy_l = (nz * ny) // P
        return ("y", 2, gy_l, nx, gy_l // 2)
    gy_l = nz // P
    return ("y", 2, gy_l, ny * nx, gy_l // 2)


def phat_from_p(Pm, grp: np.ndarray, dims, axis: int):
    """P̂ (n × n): every entry P[i, c] moved to the fine column of c's
    parity-matching member, so P̂·broadcast(ec) == P·ec (a clamp guards
    ragged edges)."""
    import scipy.sparse as sp
    nz, ny, nx = dims
    cd = [nz, ny, nx]
    cd[axis] = -(-dims[axis] // 2)
    Pm = Pm.tocsr()
    n = Pm.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(Pm.indptr))
    c = Pm.indices.astype(np.int64)
    jcoord = [c // (cd[1] * cd[2]), (c // cd[2]) % cd[1], c % cd[2]]
    icoord = [rows // (ny * nx), (rows // nx) % ny, rows % nx]
    jcoord[axis] = np.minimum(jcoord[axis] * 2 + (icoord[axis] % 2), dims[axis] - 1)
    j = (jcoord[0] * ny + jcoord[1]) * nx + jcoord[2]
    return sp.csr_matrix((Pm.data.copy(), j.astype(np.int64), Pm.indptr.copy()),
                         shape=(n, n))


def build_dist_rs(A: CSR, nshards: int, theta: float = 0.25, max_levels: int = 12,
                  coarse_size: int = 512, smoother: str = "chebyshev", degree: int = 2,
                  dtype=None, max_pdiags: int = 40, theta_dir: float = 4.0,
                  device="cpu") -> Optional[DistSA]:
    """The classical hierarchy as a ``DistSA`` on ``device``, or None when A
    is not a shard-alignable lattice (the launcher falls back to saamg)."""
    import scipy.sparse as sp
    dtype = dtype or np.asarray(A.data).dtype
    n = A.shape[0]
    dims = detect_grid3(A)
    if dims is None or dims[0] * dims[1] * dims[2] != n or n % nshards:
        return None
    if not any(axis_feasible(dims, a, nshards) for a in range(3)):
        return None
    Al = A.to_scipy().tocsr().astype(np.float64)
    host_levels = []
    prev_axis = None
    for _ in range(max_levels):
        if Al.shape[0] <= coarse_size:
            break
        s = _axis_strengths(Al, dims)
        ok = [axis_feasible(dims, a, nshards) for a in range(3)]
        axis = None
        for a in range(3):
            others = max(max((s[b] for b in range(3) if b != a), default=0.0), 1e-300)
            if ok[a] and s[a] >= theta_dir * others:
                axis = a
                break
        if axis is None:
            start = (prev_axis + 1) if prev_axis is not None else 2
            axis = next(((start + k) % 3 for k in range(3) if ok[(start + k) % 3]), None)
        if axis is None:
            break                       # alignment exhausted: the coarse solve takes it
        prev_axis = axis
        nl = Al.shape[0]
        agg = ("ax", axis, dims)
        grp, M = group_index(agg, 2, nl)
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        S = strength_graph(Al, theta)
        crows = elect_cpoints(S, grp, M, axis_parity(agg, nl))
        state = np.full(nl, -1, dtype=np.int8)
        state[crows] = 1
        Pm = direct_interpolation(Al, S, state)
        Pm = sp.csr_matrix((Pm.data, grp[np.sort(crows)][Pm.indices], Pm.indptr),
                           shape=(nl, M))
        Pm, _, _ = cap_offsets(Pm, grp, max_pdiags)
        lmax = lambda_est(Al, dinv)
        Ac = native.rap(Al, Pm, np.arange(M, dtype=np.int64), M) \
            if native.available() else None
        if Ac is None:
            Ac = (Pm.T @ Al @ Pm).tocsr()
        Ac.eliminate_zeros()
        zd = Ac.diagonal() == 0
        if zd.any():
            Ac = (Ac + sp.diags(zd.astype(np.float64))).tocsr()
        Ac.sort_indices()
        host_levels.append((Al, phat_from_p(Pm, grp, dims, axis), dinv, lmax, axis, dims, M))
        Al = Ac
        dims = coarse_dims(agg)
    if not host_levels:
        return None

    def part(M):
        return partition_matrix(CSR.from_scipy(M.astype(dtype)), nshards).to(device)

    dlev = []
    for Ah, Phat, dinv, lmax, axis, ldims, M in host_levels:
        assert Ah.shape[0] % nshards == 0 and M % nshards == 0, (Ah.shape[0], M, nshards)
        dlev.append(DistSALevel(
            A=part(Ah), B=part(Phat), C=part(Phat.T.tocsr()),
            dinv=torch.from_numpy(dinv.astype(dtype).reshape(nshards, -1)).to(device),
            lmax=float(lmax), g=2, smoother=smoother, degree=degree,
            n_next=M // nshards, agg=_local_agg(ldims, axis, nshards), tri=None,
            nshards=nshards))
    nc = Al.shape[0]
    nc_pad = -(-nc // nshards) * nshards
    ci = np.zeros((nc_pad, nc_pad), dtype=dtype)
    ci[:nc, :nc] = np.linalg.pinv(Al.toarray()).astype(dtype)
    return DistSA(levels=tuple(dlev), coarse_inv=torch.from_numpy(ci).to(device), n_top=n)
