"""Tridiagonal solves by parallel cyclic reduction (PCR), for the multigrid
LINE smoother (``amg/sa.py``; ``lssp_tpu/ops/tridiag.py``).

PCR eliminates the couplings in ceil(log2 n) full-width steps, each a
handful of shifted elementwise operations, where the Thomas algorithm is a
sequential recurrence.  Zero off-diagonals decouple the system into
independent lines, so one (n,) tridiagonal whose couplings vanish at
grid-row boundaries is the batched per-line solve.

The coefficients are (n,) vectors, or (n, P) for P independent systems
(the shards of the distributed solve, side by side); the right-hand side
has the coefficients' shape, or one more trailing axis of k columns
(``ops/spmv.py``'s block layout), every column a system with the same
coefficients, as JAX's solve runs under ``vmap``.

The distributed line smoother's cross-shard solve is the Spike algorithm
(``dist_pcr_solve``, and ``dist_spike_solve`` with the b-independent part
from ``spike_interface_host``): every shard solves its own tridiagonal
with PCR, and a (2P, 2P) interface system couples the first and last
unknowns of the shards, so a line may cross shard boundaries.  On the
port's mesh a rank's shards are the leading axis of (P_loc, R) tensors;
the interface values of every rank's shards come from one all-gather over
the ranks of the mesh's group (a slice without a group).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def _shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """``a`` shifted by ``s`` rows, zero-filled: row i holds a[i - s]."""
    n = a.shape[0]
    if s == 0:
        return a
    out = torch.zeros_like(a)
    if abs(s) < n:
        if s > 0:
            out[s:] = a[:n - s]
        else:
            out[:n + s] = a[-s:]
    return out


def _cols(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A coefficient array broadcast over b's trailing column axis."""
    return v.reshape(v.shape + (1,) * (b.ndim - v.ndim))


def pcr_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
              steps: Optional[int] = None) -> torch.Tensor:
    """Solve T x = b for the tridiagonal T with sub-, main- and
    super-diagonal ``dl``, ``d``, ``du`` (dl[0] = du[n-1] = 0, the banded
    layout), each (n,) or (n, P); ``b`` their shape or with a trailing
    column axis.  At step k (stride s = 2^k) every
    equation eliminates its couplings to i±s with rows i±s; after
    ceil(log2 n) steps the system is diagonal.  Stable for diagonally
    dominant systems (the line-smoother case)."""
    n = d.shape[0]
    if steps is None:
        steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    s = 1
    for _ in range(steps):
        d_l, d_r = _shift(d, s), _shift(d, -s)
        dl_l, du_r = _shift(dl, s), _shift(du, -s)
        b_l, b_r = _shift(b, s), _shift(b, -s)
        dl_r, du_l = _shift(dl, -s), _shift(du, s)
        safe_l = torch.where(d_l == 0, torch.ones_like(d_l), d_l)
        safe_r = torch.where(d_r == 0, torch.ones_like(d_r), d_r)
        alpha = -dl / safe_l
        beta = -du / safe_r
        d = d + alpha * du_l + beta * dl_r
        b = b + _cols(alpha, b) * b_l + _cols(beta, b) * b_r
        dl = alpha * dl_l
        du = beta * du_r
        s *= 2
    return b / _cols(torch.where(d == 0, torch.ones_like(d), d), b)


def tridiag_parts(A_dia):
    """(dl, d, du) of a DIA (offsets -1, 0, +1; zeros where absent): the
    line-smoother setup.  Row-aligned storage puts A[i, i-1] at data(-1)[i]
    and A[i, i+1] at data(+1)[i], with the out-of-range slots already 0."""
    offs = A_dia.offsets

    def diag(off):
        if off in offs:
            return A_dia.data[offs.index(off)].clone()
        return torch.zeros(A_dia.shape[0], dtype=A_dia.data.dtype, device=A_dia.data.device)

    return diag(-1), diag(0), diag(1)


def line_jacobi_sweeps(tri, Aop: Callable, x: torch.Tensor, b: torch.Tensor, degree: int,
                       damping: float = 0.7, tri_solve: Callable = pcr_solve) -> torch.Tensor:
    """Damped line Jacobi: ``degree`` sweeps of x += damping·T⁻¹(b − A x),
    T the strong-direction tridiagonal part of A."""
    dl, d0, du = tri
    for _ in range(degree):
        x = x + damping * tri_solve(dl, d0, du, b - Aop(x))
    return x


def _shard_pcr(dl, d, du, b):
    """PCR on every shard at once: coefficients (P, R), b (P, R) or
    (P, R, k); the cross-shard couplings dl[:, 0] and du[:, -1] are cut."""
    dl = dl.clone()
    du = du.clone()
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    return pcr_solve(dl.T, d.T, du.T, b.transpose(0, 1)).transpose(0, 1)


def _interface_correct(y, vspike, wspike, u, p0: int = 0):
    """x = y − v·u_prev − w·u_next: the correction of the shards
    [p0, p0 + y.shape[0]) from the interface unknowns u (2P, ...) =
    [x_p[0], x_p[-1]] of every global shard."""
    P = u.shape[0] // 2
    zero = u.new_zeros((1,) + tuple(u.shape[1:]))
    u_prev = torch.cat([zero, u[1:2 * P - 2:2]])        # u[2p-1], 0 on shard 0
    u_next = torch.cat([u[2:2 * P:2], zero])            # u[2p+2], 0 on shard P-1
    own = slice(p0, p0 + y.shape[0])
    return (y - _cols(vspike, y) * u_prev[own, None]
            - _cols(wspike, y) * u_next[own, None])


def _interface_matrix(v0, vR, w0, wR, dtype, device):
    """The (2P, 2P) interface matrix of the Spike solve."""
    P = v0.shape[0]
    p2 = 2 * torch.arange(P, device=device)
    M = torch.eye(2 * P, dtype=dtype, device=device)
    M[p2, (p2 - 1) % (2 * P)] += v0
    M[p2 + 1, (p2 - 1) % (2 * P)] += vR
    M[p2, (p2 + 2) % (2 * P)] += w0
    M[p2 + 1, (p2 + 2) % (2 * P)] += wR
    return M


def dist_pcr_solve(dl, d, du, b):
    """The distributed tridiagonal solve by Spike substructuring, exact when
    lines cross shard boundaries (``lssp_tpu/ops/tridiag.py:113``): every
    shard's PCR with three right-hand sides (b and the boundary spikes
    v = T_loc⁻¹(a_lo·e₁), w = T_loc⁻¹(a_hi·e_R), a_lo = dl[p, 0] and a_hi =
    du[p, -1] the cross-shard couplings), the (2P, 2P) interface system
    of the shards' first and last unknowns, and the rank-2 correction.
    Coefficients (P, R), b (P, R); the global edges have dl[0, 0] =
    du[P-1, -1] = 0, so the wrapped interface entries only add zeros."""
    e1 = torch.zeros_like(b)
    eR = torch.zeros_like(b)
    e1[:, 0] = dl[:, 0]
    eR[:, -1] = du[:, -1]
    y, v, w = _shard_pcr(dl, d, du, torch.stack([b, e1, eR], dim=-1)).unbind(-1)
    M = _interface_matrix(v[:, 0], v[:, -1], w[:, 0], w[:, -1], d.dtype, d.device)
    u = torch.linalg.solve(M, torch.stack([y[:, 0], y[:, -1]], dim=1).reshape(-1))
    return _interface_correct(y, v, w, u)


def spike_interface_host(dl, d, du):
    """The b-independent part of the Spike solve, on the host at setup
    (``lssp_tpu/ops/tridiag.py:160``): every shard's boundary spikes v, w
    (P, R) and the inverse of the (2P, 2P) interface matrix.  ``dl``,
    ``d``, ``du`` are the stacked (P, R) shard slices (numpy)."""
    import scipy.linalg as sla
    dl, d, du = np.asarray(dl), np.asarray(d), np.asarray(du)
    P, R = d.shape
    v = np.zeros((P, R), d.dtype)
    w = np.zeros((P, R), d.dtype)
    for p in range(P):
        ab = np.zeros((3, R), np.float64)
        ab[0, 1:] = du[p, :-1]          # superdiagonal (du[i] = A[i, i+1])
        ab[1] = d[p]
        ab[2, :-1] = dl[p, 1:]          # subdiagonal (dl[i] = A[i, i-1])
        ab[1, ab[1] == 0.0] = 1.0       # decoupled slots stay solvable
        rhs = np.zeros((R, 2), np.float64)
        rhs[0, 0] = dl[p, 0]            # a_lo · e1
        rhs[-1, 1] = du[p, -1]          # a_hi · eR
        sol = sla.solve_banded((1, 1), ab, rhs)
        v[p] = sol[:, 0]
        w[p] = sol[:, 1]
    p2 = 2 * np.arange(P)
    M = np.eye(2 * P)
    M[p2, (p2 - 1) % (2 * P)] += v[:, 0]
    M[p2 + 1, (p2 - 1) % (2 * P)] += v[:, -1]
    M[p2, (p2 + 2) % (2 * P)] += w[:, 0]
    M[p2 + 1, (p2 + 2) % (2 * P)] += w[:, -1]
    return v, w, np.linalg.inv(M).astype(d.dtype)


def dist_spike_solve(dl, d, du, vspike, wspike, Minv, b, mesh=None):
    """The Spike solve with the spikes and interface inverse of
    ``spike_interface_host`` (``lssp_tpu/ops/tridiag.py:198``): one PCR
    right-hand side a shard, the interface values, a small matrix-vector
    product (multiply and sum, as JAX's) and the correction.  Coefficients,
    spikes and b are this rank's shards, (P_loc, R) (b also (P_loc, R, k));
    Minv is whole, (2P, 2P) over every global shard.  Over the ranks of
    ``mesh``'s group the shards' end values are all-gathered in rank
    order, and every rank forms the whole u, as one process does, so the
    result is bitwise the one-process solve's."""
    from lssp_tpu_torch.parallel.dist_ops import gather_rows
    y = _shard_pcr(dl, d, du, b)
    ends = gather_rows(torch.stack([y[:, 0], y[:, -1]], dim=1), mesh)
    rhs = ends.reshape((-1,) + tuple(b.shape[2:]))
    u = (_cols(Minv, rhs[None]) * rhs[None]).sum(dim=1)
    p0 = mesh.rank * mesh.slots if mesh is not None else 0
    return _interface_correct(y, vspike, wspike, u, p0)
