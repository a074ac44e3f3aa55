"""Classical (Ruge–Stüben-type) AMG with gather-free transfers (``pc="rsamg"``;
``lssp_tpu/amg/rs.py``).

* **One C-point per reshape group.**  Each level is split into PAIRS
  along one lattice axis (the strongest-coupled direction, rotating
  through the axes when couplings are balanced) or into contiguous
  g-ranges when no grid is detected.  Each group elects one C-point (the
  member with the most in-group strength, ties toward the even coordinate
  so the C lattice stays aligned), and the coarse index of a C-point is
  its group index.
* **Classical direct interpolation** (``amg/setup.py``) onto those
  C-points; flat levels add one Jacobi smoothing pass.
* **Aggregated-diagonal P (AggP).**  Every entry P[i, c] sits at a coarse
  offset d = grp(c) − grp(i) from a small static set, so P is one weight
  vector per offset: prolongation is Σ_d data[d] ⊙ broadcast(shift(ec,
  d)), restriction Σ_d place(group_sum(data[d] ⊙ r), d).  Offsets are
  capped (``max_pdiags``) with a row-sum-preserving rescale, and the capped
  P feeds the Galerkin product, so the cycle applies exactly the hierarchy
  the host built.

The host setup is a copy of the JAX package's; level operators go to the
device as DIA (ELL beyond 96 diagonals), so a cycle is DIA products
(kernel K1 on CUDA) plus slices, reshape-sums and multiplies, and the
smoothing is ``amg/sa.py``'s.  Every device function takes a vector (n,)
or an (n, k) block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from lssp_tpu_torch import native
from lssp_tpu_torch.amg.cycle import residual
from lssp_tpu_torch.amg.sa import (
    _filter_lumped, _pad_identity, _size_below, _smooth, _to_dia, detect_grid, pad_rows,
)
from lssp_tpu_torch.amg.setup import direct_interpolation, lambda_est, strength_graph, truncate_P
from lssp_tpu_torch.config import resolve_device, smoother_degree
from lssp_tpu_torch.sparse.convert import csr_entry_offsets
from lssp_tpu_torch.sparse.types import CSR
from lssp_tpu_torch.utils import profile as _prof

AXES = ("z", "y", "x")


# --------------------------------------------------------------------------
# grid detection (host)
# --------------------------------------------------------------------------

def detect_grid3(A) -> Optional[Tuple[int, int, int]]:
    """(nz, ny, nx) if A's sparsity matches a row-major lattice stencil;
    2-D grids return nz=1.  Builds on sa.detect_grid (which finds the
    innermost period nx) and then factors the outer dimension the same
    way: outer offsets dy = rint(off/nx) must all fall within a small
    halfwidth of multiples of some ny."""
    g2 = detect_grid(A)
    if g2 is None:
        return None
    gy, nx = g2
    _, _, offs = csr_entry_offsets(A.indptr, A.indices, A.shape[0])
    offs = offs.astype(np.int64)
    dy = np.rint(offs / nx).astype(np.int64)
    hw = 1
    cands = np.unique(np.abs(dy[np.abs(dy) > hw]))
    best = None
    for N in cands:
        N = int(N)
        if N <= 2 * hw + 1 or gy % N:
            continue
        dz = dy - np.rint(dy / N).astype(np.int64) * N
        if np.all(np.abs(dz) <= hw):
            cost = int(np.sum(np.abs(dz)))
            if best is None or cost < best[0]:
                best = (cost, N)
    if best is None:
        return (1, gy, nx)
    ny = best[1]
    return (gy // ny, ny, nx)


def _axis_strengths(Al, dims) -> Tuple[float, float, float]:
    """Total |coupling| along each lattice axis (z, y, x) — one O(#diags)
    pass over the per-diagonal |a| sums."""
    nz, ny, nx = dims
    Ac = Al.tocsr()
    n = Ac.shape[0]
    ip, ind, dat = Ac.indptr, Ac.indices, Ac.data
    if len(ind) > 20_000_000:
        # direction RATIOS of a near-constant-stencil operator are exact
        # on a leading row block up to boundary effects (same sampling
        # rule as sa._grid_strengths; the full 84M-entry scan was ~4 s
        # of the 16.8M classical setup)
        ns = int(np.searchsorted(ip, 8_000_000))
        ns = min(n, max(ns, min(n, 4 * ny * nx)))
        ip = ip[:ns + 1]
        ind = ind[:ip[-1]]
        dat = dat[:ip[-1]]
    _, d, offs = csr_entry_offsets(ip, ind, len(ip) - 1)
    idx = np.searchsorted(offs, d)
    sums = np.bincount(idx, weights=np.abs(dat), minlength=len(offs))
    o = offs.astype(np.int64)
    dy = np.rint(o / nx).astype(np.int64)
    dz = np.rint(dy / max(ny, 1)).astype(np.int64)
    dyy = dy - dz * max(ny, 1)
    dx = o - dy * nx
    sx = float(sums[(dz == 0) & (dyy == 0) & (dx != 0)].sum())
    sy = float(sums[(dz == 0) & (dyy != 0)].sum())
    sz = float(sums[dz != 0].sum())
    return sz, sy, sx


def choose_axis(Al, dims, theta_dir: float,
                prev_axis: Optional[int] = None) -> Optional[int]:
    """Coarsening axis: the dominant direction if one exceeds the others
    by ``theta_dir``, else rotate through the coarsenable axes starting
    after the previous level's choice (full coarsening over d levels)."""
    s = _axis_strengths(Al, dims)
    ok = [dims[a] > 1 for a in range(3)]
    if not any(ok):
        return None
    for a in range(3):
        others = max(max((s[b] for b in range(3) if b != a), default=0.0),
                     1e-300)
        if ok[a] and s[a] >= theta_dir * others:
            return a
    start = (prev_axis + 1) if prev_axis is not None else 2
    for k in range(3):
        a = (start + k) % 3
        if ok[a]:
            return a
    return None


# --------------------------------------------------------------------------
# group machinery (host)
# --------------------------------------------------------------------------

def group_index(agg, g: int, n: int) -> Tuple[np.ndarray, int]:
    """Fine row → reshape-group index, and the group count M.  ``agg`` is
    None (flat contiguous g-ranges, n % g == 0) or ("ax", axis, dims) —
    pairs along one lattice axis of the row-major dims."""
    if agg is None:
        assert n % g == 0, (n, g)
        return np.arange(n, dtype=np.int64) // g, n // g
    _, axis, dims = agg
    nz, ny, nx = dims
    idx = np.arange(n, dtype=np.int64)
    cc = [idx // (ny * nx), (idx // nx) % ny, idx % nx]
    cd = list(dims)
    cc[axis] = cc[axis] // 2
    cd[axis] = -(-dims[axis] // 2)
    return (cc[0] * cd[1] + cc[1]) * cd[2] + cc[2], cd[0] * cd[1] * cd[2]


def coarse_dims(agg) -> Tuple[int, int, int]:
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    return tuple(cd)


def axis_parity(agg, n: int) -> np.ndarray:
    """Even/odd coordinate along the coarsening axis — the ALIGNED
    C-election tie-break."""
    _, axis, dims = agg
    nz, ny, nx = dims
    idx = np.arange(n, dtype=np.int64)
    cc = (idx // (ny * nx), (idx // nx) % ny, idx % nx)
    return cc[axis] % 2


def elect_cpoints(S, grp: np.ndarray, M: int,
                  parity: Optional[np.ndarray] = None) -> np.ndarray:
    """One C-point per group: the member with the largest in-group strength
    degree; ties prefer ``parity == 0`` (the aligned lattice), then lowest
    index.  Returns the C row index per group."""
    n = S.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    ingrp = grp[rows] == grp[S.indices]
    deg = np.bincount(rows[ingrp], minlength=n)
    par = parity if parity is not None else np.zeros(n, dtype=np.int64)
    # per-group argmax of (deg, even-parity, lowest index) via ONE packed
    # int64 key + np.maximum.at — the 3-key lexsort over the full level
    # was 4.3 s of the 16.8M classical setup
    key = ((np.minimum(deg, (1 << 20) - 1).astype(np.int64) << 33)
           | ((1 - par).astype(np.int64) << 32)
           | (n - 1 - np.arange(n, dtype=np.int64)))
    best = np.zeros(M, dtype=np.int64)
    np.maximum.at(best, grp, key)
    return (n - 1) - (best & ((1 << 32) - 1))


def cap_offsets(P, grp: np.ndarray, max_pdiags: int):
    """Restrict P's entries to the ``max_pdiags`` coarse offsets carrying
    the most absolute mass; dropped rows rescale to preserve row sums
    (constants stay exactly interpolated).  Returns (P_capped, offsets,
    kept_mass_fraction)."""
    import scipy.sparse as sp
    P = P.tocsr()
    n = P.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(P.indptr))
    off = P.indices.astype(np.int64) - grp[rows]
    uniq, inv = np.unique(off, return_inverse=True)
    if len(uniq) <= max_pdiags:
        return P, tuple(int(o) for o in uniq), 1.0
    mass = np.bincount(inv, weights=np.abs(P.data), minlength=len(uniq))
    keep_ids = np.sort(np.argsort(-mass)[:max_pdiags])
    kept = np.zeros(len(uniq), dtype=bool)
    kept[keep_ids] = True
    keep = kept[inv]
    frac = float(mass[keep_ids].sum() / max(mass.sum(), 1e-300))
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, P.data)
    newsum = np.zeros(n)
    np.add.at(newsum, rows[keep], P.data[keep])
    scale = np.where((newsum != 0) & (rowsum != 0),
                     rowsum / np.where(newsum == 0, 1.0, newsum), 1.0)
    P2 = sp.csr_matrix(
        (P.data[keep] * scale[rows[keep]], P.indices[keep],
         np.concatenate([[0], np.cumsum(np.bincount(rows[keep],
                                                    minlength=n))])),
        shape=P.shape)
    return P2, tuple(int(o) for o in uniq[keep_ids]), frac


# --------------------------------------------------------------------------
# AggP: interpolation in aggregated-diagonal layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggP:
    """Interpolation P (n × M) with every entry at a static coarse offset:
    ``data[d, i] = P[i, grp(i) + offsets[d]]``, grp the reshape-group map
    that ``agg`` / ``g`` describe."""

    offsets: Tuple[int, ...]
    data: Any                       # (ndiag, n)
    g: int                          # flat aggregate width
    agg: Any                        # ("ax", axis, dims) or None
    shape: Tuple[int, int]          # (n, M)

    @property
    def dtype(self):
        return self.data.dtype


def to_aggp(P, grp: np.ndarray, g: int, agg, offsets, dtype=np.float64) -> AggP:
    """Exact conversion of an (n × M) scipy CSR interpolation whose entries
    all sit on ``offsets`` into the AggP layout (numpy data)."""
    P = P.tocsr()
    n, M = P.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(P.indptr))
    off = P.indices.astype(np.int64) - grp[rows]
    pos = {o: d for d, o in enumerate(offsets)}
    data = np.zeros((len(offsets), n), dtype=dtype)
    if len(off):
        d_idx = np.array([pos[o] for o in off], dtype=np.int64)
        data[d_idx, rows] = P.data
    return AggP(offsets=tuple(offsets), data=data, g=g, agg=agg, shape=(n, M))


def _grp_broadcast(agg, g: int, M: int, v):
    """Coarse (M,) → fine (n,) (trailing columns kept): each group's value
    over its members (pairs duplicate along the axis; ragged edges slice)."""
    tail = tuple(v.shape[1:])
    if agg is None:
        return v[:, None].expand((M, g) + tail).reshape((-1,) + tail)
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    T = torch.repeat_interleave(v.reshape(tuple(cd) + tail), 2, dim=axis)
    if 2 * cd[axis] != dims[axis]:
        T = T.narrow(axis, 0, dims[axis])
    return T.reshape((-1,) + tail)


def _grp_sum(agg, g: int, M: int, t):
    """Fine (n,) → coarse (M,) (trailing columns kept): the sum of each
    group's members (ragged edges pad)."""
    tail = tuple(t.shape[1:])
    if agg is None:
        return t.reshape((M, g) + tail).sum(dim=1)
    _, axis, dims = agg
    cd = list(dims)
    cd[axis] = -(-dims[axis] // 2)
    T = t.reshape(tuple(dims) + tail)
    if 2 * cd[axis] != dims[axis]:
        full = list(T.shape)
        full[axis] = 2 * cd[axis]
        Tp = torch.zeros(full, dtype=T.dtype, device=T.device)
        Tp.narrow(axis, 0, dims[axis]).copy_(T)
        T = Tp
    shape5 = list(T.shape)
    shape5[axis] = cd[axis]
    shape5.insert(axis + 1, 2)
    return T.reshape(shape5).sum(dim=axis + 1).reshape((-1,) + tail)


def _span(P: AggP):
    lo = max(0, -min(P.offsets)) if P.offsets else 0
    hi = max(0, max(P.offsets)) if P.offsets else 0
    return lo, hi


def aggp_prolong(P: AggP, ec):
    """y = P @ ec: per offset, a static slice of the once-padded coarse
    vector broadcast over the groups, times the offset's weights."""
    n, M = P.shape
    lo, hi = _span(P)
    tail = tuple(ec.shape[1:])
    ec_p = torch.zeros((M + lo + hi,) + tail, dtype=ec.dtype, device=ec.device)
    ec_p[lo:lo + M] = ec
    y = torch.zeros((n,) + tail, dtype=ec.dtype, device=ec.device)
    for d, off in enumerate(P.offsets):
        w = P.data[d][:, None] if tail else P.data[d]
        y = y + w * _grp_broadcast(P.agg, P.g, M, ec_p[lo + off:lo + off + M])
    return y


def aggp_restrict(P: AggP, r):
    """rc = Pᵀ @ r: per offset, a group reshape-sum of the weighted residual
    added back at the offset."""
    n, M = P.shape
    lo, hi = _span(P)
    tail = tuple(r.shape[1:])
    rc = torch.zeros((M + lo + hi,) + tail, dtype=r.dtype, device=r.device)
    for d, off in enumerate(P.offsets):
        w = P.data[d][:, None] if tail else P.data[d]
        # gs[m] belongs to coarse index m + off (buffer slot lo + off + m)
        rc[lo + off:lo + off + M] = rc[lo + off:lo + off + M] + _grp_sum(P.agg, P.g, M, w * r)
    return rc[lo:lo + M]


# --------------------------------------------------------------------------
# host setup
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RSLevelHost:
    A: Any                  # scipy CSR (n × n), flat levels pre-padded
    P: Any                  # scipy CSR (n × M), offset-capped
    grp: np.ndarray
    g: int
    agg: Any
    offsets: Tuple[int, ...]
    dinv: np.ndarray
    lmax: float
    kept_mass: float
    zero_rows: int          # F rows left with no interpolation


@dataclasses.dataclass
class RSHierarchyHost:
    levels: list
    A_coarse: Any           # scipy CSR
    n_top: int


def rs_host_setup(A: CSR, theta: float = 0.25, max_levels: int = 12,
                  coarse_size: int = 64, g: int = 4,
                  smooth_interp: bool = True,
                  interp_omega: float = 2.0 / 3.0, trunc: float = 0.2,
                  max_pdiags: int = 40, grid=None, theta_dir: float = 4.0,
                  filter_tol: float = 1e-3) -> RSHierarchyHost:
    """Grouped classical setup: axis-pair groups (direction-aware, aligned
    C lattice) or flat g-ranges elect one C-point each; classical direct
    interpolation (Stüben rule, amg/setup.py) onto those C-points;
    Galerkin RAP with the offset-capped P."""
    import scipy.sparse as sp
    n_top = A.shape[0]
    Al = A.to_scipy().tocsr().astype(np.float64)
    if grid is None:
        dims = detect_grid3(A)
    elif grid is False:
        dims = None
    else:
        dims = tuple(grid) if len(grid) == 3 else (1,) + tuple(grid)
    if dims is not None and dims[0] * dims[1] * dims[2] != n_top:
        dims = None
    levels = []
    prev_axis = None
    for _ in range(max_levels):
        if Al.shape[0] <= coarse_size:
            break
        axis = choose_axis(Al, dims, theta_dir, prev_axis) \
            if dims is not None else None
        if axis is None:
            agg = dims = None
            Al = _pad_identity(Al, (-Al.shape[0]) % g)
        else:
            agg = ("ax", axis, dims)
            prev_axis = axis
        n = Al.shape[0]
        lev_g = 2 if agg is not None else g
        grp, M = group_index(agg, lev_g, n)
        parity = axis_parity(agg, n) if agg is not None else None
        d = Al.diagonal().copy()
        d[d == 0] = 1.0
        dinv = 1.0 / d
        S = strength_graph(Al, theta)
        crows = elect_cpoints(S, grp, M, parity)
        state = np.full(n, -1, dtype=np.int8)
        state[crows] = 1
        P = direct_interpolation(Al, S, state)
        # direct_interpolation numbers C by fine order; recolumn to groups
        cmap_grp = grp[np.sort(crows)]
        P = sp.csr_matrix((P.data, cmap_grp[P.indices], P.indptr),
                          shape=(n, M))
        if smooth_interp and agg is None:
            # flat (unstructured) levels: one Jacobi pass fills the zero
            # rows of F-points whose strong neighbours hold no C, then
            # truncation bounds the reach.  Grid levels skip smoothing —
            # aligned in-line direct interpolation already covers every
            # F-point, and an unsmoothed P keeps the Galerkin stencil at
            # its tensor fixed point instead of compounding.
            P = ((sp.eye(n) - interp_omega * sp.diags(dinv) @ Al)
                 @ P).tocsr()
            if trunc:
                P = truncate_P(P, trunc)
        P, offsets, kept = cap_offsets(P, grp, max_pdiags)
        zero_rows = int((np.diff(P.indptr) == 0).sum())
        lmax = lambda_est(Al, dinv)
        # Galerkin RAP through the fused C++ kernel (native/src/rap.cpp):
        # pass P as the row-expansion operand with an identity column map
        # (P.row(k) is already in coarse indices) — scipy tocsc/matmat
        # fallback kept as the oracle
        Ac = native.rap(Al, P, np.arange(M, dtype=np.int64), M) \
            if native.available() else None
        if Ac is None:
            Ac = (P.T @ Al @ P).tocsr()
        Ac.eliminate_zeros()
        # lumped strength filter (sa.py rule, row sums preserved): bounds
        # the coarse-stencil growth that compounds through repeated RAPs
        Ac = _filter_lumped(Ac, filter_tol)
        # groups whose C row ended up with a zero P column (never for the
        # elected identity rows, but guard) → keep the operator nonsingular
        zd = Ac.diagonal() == 0
        if zd.any():
            Ac = (Ac + sp.diags(zd.astype(np.float64))).tocsr()
        Ac.sort_indices()
        levels.append(RSLevelHost(A=Al, P=P, grp=grp, g=lev_g, agg=agg,
                                  offsets=offsets, dinv=dinv, lmax=lmax,
                                  kept_mass=kept, zero_rows=zero_rows))
        Al = Ac
        if dims is not None:
            dims = coarse_dims(agg)
    return RSHierarchyHost(levels=levels, A_coarse=Al, n_top=n_top)


# --------------------------------------------------------------------------
# device hierarchy and cycle
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RSLevel:
    A: Any              # DIA (or ELL) device operator
    P: AggP             # (n × M)
    dinv: Any           # (n,)
    lmax: float
    smoother: str
    degree: int
    tri: Any = None     # none: pointwise smoothers only (sa._smooth's protocol)
    g: int = 2


@dataclasses.dataclass(frozen=True)
class RSAMG:
    levels: Tuple[RSLevel, ...]
    coarse_inv: Any
    cycles: int
    n_top: int          # unpadded fine size
    gamma: int = 1      # 1 = V-cycle, 2 = W-cycle


def build_device_rs(hier: RSHierarchyHost, dtype=np.float64, smoother: str = "chebyshev",
                    degree: int = 2, cycles: int = 1, max_diags: int = 96,
                    gamma: int = 1, device=None) -> RSAMG:
    device = resolve_device(device)
    levels = []
    for lev in hier.levels:
        Pagg = to_aggp(lev.P, lev.grp, lev.g, lev.agg, lev.offsets, dtype=dtype)
        Pagg = AggP(offsets=Pagg.offsets, data=torch.from_numpy(Pagg.data).to(device),
                    g=Pagg.g, agg=Pagg.agg, shape=Pagg.shape)
        levels.append(RSLevel(
            A=_to_dia(lev.A, dtype, max_diags, device), P=Pagg,
            dinv=torch.from_numpy(lev.dinv.astype(dtype)).to(device), lmax=float(lev.lmax),
            smoother=smoother, degree=degree, g=lev.g))
    coarse_inv = torch.from_numpy(
        np.linalg.pinv(hier.A_coarse.toarray()).astype(dtype)).to(device)
    return RSAMG(levels=tuple(levels), coarse_inv=coarse_inv, cycles=cycles,
                 n_top=hier.n_top, gamma=gamma)


def _cycle(h: RSAMG, l: int, b_l, x_l, gamma: int):
    """One cycle from level ``l``; the visit is the span
    ``lssp.amg.level.<l>`` (the coarse solve the deepest)."""
    with _prof.annotate(_prof.amg_level(l)):
        if l == len(h.levels):
            return h.coarse_inv @ b_l
        lev = h.levels[l]
        x_l = _smooth(lev, x_l, b_l)
        rc = pad_rows(aggp_restrict(lev.P, residual(lev.A, x_l, b_l)), _size_below(h, l))
        ec = _cycle(h, l + 1, rc, torch.zeros_like(rc), gamma)
        for _ in range(gamma - 1):
            # W-cycle: revisit the coarse hierarchy with the current correction
            ec = _cycle(h, l + 1, rc, ec, gamma)
        x_l = x_l + aggp_prolong(lev.P, ec[:lev.P.shape[1]])
        return _smooth(lev, x_l, b_l)


def _top_size(h: RSAMG) -> int:
    return h.levels[0].A.shape[0] if h.levels else h.coarse_inv.shape[0]


def rs_vcycle(h: RSAMG, b, x=None):
    """``h.cycles`` V- (or W-) cycles; the top level's flat padding is
    added to b and x and cut from the result."""
    bp = pad_rows(b, _top_size(h))
    xp = torch.zeros_like(bp) if x is None else pad_rows(x, _top_size(h))
    for _ in range(h.cycles):
        xp = _cycle(h, 0, bp, xp, h.gamma)
    return xp[:b.shape[0]]


def rs_fmg_initial(h: RSAMG, b):
    """Full-multigrid initial guess: restrict b down, solve the coarsest
    exactly, one V-cycle per level on the way up."""
    bs = [pad_rows(b, _top_size(h))]
    for l in range(len(h.levels)):
        bs.append(pad_rows(aggp_restrict(h.levels[l].P, bs[-1]), _size_below(h, l)))
    x = h.coarse_inv @ bs[-1]
    for l in range(len(h.levels) - 1, -1, -1):
        x = aggp_prolong(h.levels[l].P, x[:h.levels[l].P.shape[1]])
        x = _cycle(h, l, bs[l], x, 1)
    return x[:b.shape[0]]


# --------------------------------------------------------------------------
# preconditioner
# --------------------------------------------------------------------------

def _rs_apply(state, r):
    return rs_vcycle(state, r)


def setup_rs_pc(A: CSR, opts, device=None):
    """The rsamg preconditioner, on ``device`` (``config.resolve_device``:
    the current CUDA device unless one is named)."""
    from lssp_tpu_torch.pc.base import Preconditioner
    with _prof.phase("amg_host_levels"):
        hier = rs_host_setup(A, theta=opts.amg_theta, max_levels=opts.amg_max_levels,
                             coarse_size=opts.amg_coarse_size,
                             smooth_interp=opts.amg_smooth_interp, trunc=opts.amg_trunc,
                             max_pdiags=opts.amg_max_pdiags)
    with _prof.phase("amg_pack_upload"):
        h = build_device_rs(
            hier, dtype=np.asarray(A.data).dtype,
            smoother=opts.amg_smoother if opts.amg_smoother != "l1jacobi" else "jacobi",
            degree=smoother_degree(opts.amg_presmooth, opts.amg_postsmooth),
            cycles=max(1, int(opts.amg_cycles)),
            gamma=2 if str(opts.amg_cycle_type).upper() == "W" else 1, device=device)
        _prof.add_bytes("amg_pack_upload", _prof.tree_device_bytes(h))
    return Preconditioner(_rs_apply, state=h, name="amg")
