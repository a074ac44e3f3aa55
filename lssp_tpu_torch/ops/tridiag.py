"""Tridiagonal solves by parallel cyclic reduction (PCR), for the multigrid
LINE smoother (``amg/sa.py``; ``lssp_tpu/ops/tridiag.py``).

PCR eliminates the couplings in ceil(log2 n) full-width steps, each a
handful of shifted elementwise operations, where the Thomas algorithm is a
sequential recurrence.  Zero off-diagonals decouple the system into
independent lines, so one (n,) tridiagonal whose couplings vanish at
grid-row boundaries is the batched per-line solve.

The coefficients are (n,) vectors; the right-hand side is (n,) or an
(n, k) block (``ops/spmv.py``'s layout), every column a system with the
same coefficients, as JAX's solve runs under ``vmap``.  The distributed
Spike solve (``dist_pcr_solve``) waits for the distributed AMG.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

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
    """A coefficient vector broadcast over b's columns."""
    return v[:, None] if b.ndim == 2 else v


def pcr_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
              steps: Optional[int] = None) -> torch.Tensor:
    """Solve T x = b for the tridiagonal T with sub-, main- and
    super-diagonal ``dl``, ``d``, ``du`` (dl[0] = du[n-1] = 0, the banded
    layout); ``b`` (n,) or (n, k).  At step k (stride s = 2^k) every
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
