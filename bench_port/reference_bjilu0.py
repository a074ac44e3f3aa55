"""A plain reference of block-Jacobi ILU(0) under CG, in PyTorch and fp64:
what the cell ``poisson3d_204_ilu0_w4.dist`` runs, written from the
textbook and independent of the program (it imports neither the program
nor JAX).

- ``ilu0``: the ILU(0) of one diagonal block, by the IKJ elimination kept
  to the block's pattern (Saad, Iterative Methods for Sparse Linear
  Systems, 2nd ed., Algorithm 10.4), on a dense copy of the block.  The
  pattern is the block's nonzero entries, its diagonal included.
- ``neumann_apply``: the apply the port states for its block-Jacobi ILU on
  the card: with L = I + Lₛ (unit lower) and U = D(I + D⁻¹Uₛ), each
  triangular solve replaced by ``sweeps`` steps of its Neumann series,
  y ← r − Lₛ·y from y = r, then z ← D⁻¹y − (D⁻¹Uₛ)·z from z = D⁻¹y.
- ``block_jacobi``: M⁻¹ of one ILU(0) a diagonal block, by exact
  triangular solves or by the sweeps.
- ``pcg``: preconditioned conjugate gradients to a relative residual.

Dense blocks keep it plain; it is meant for the small sizes of the CPU
tests."""
from __future__ import annotations

import torch


def ilu0(block: torch.Tensor) -> torch.Tensor:
    """The ILU(0) factors of a square block, packed: the strict lower
    triangle holds Lₛ (L's unit diagonal implied), the rest U."""
    LU = block.to(torch.float64).clone()
    pattern = LU != 0
    pattern.fill_diagonal_(True)
    m = LU.shape[0]
    for i in range(1, m):
        for k in torch.nonzero(pattern[i, :i]).flatten().tolist():
            LU[i, k] = LU[i, k] / LU[k, k]
            keep = pattern[i, k + 1:]
            LU[i, k + 1:] = torch.where(keep, LU[i, k + 1:] - LU[i, k] * LU[k, k + 1:],
                                        LU[i, k + 1:])
    return LU


def split(LU: torch.Tensor):
    """(Lₛ, d, D⁻¹Uₛ) of packed factors."""
    d = torch.diagonal(LU).clone()
    return torch.tril(LU, -1), d, torch.triu(LU, 1) / d[:, None]


def neumann_apply(LU: torch.Tensor, r: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """The truncated Neumann apply of packed factors to r (fp64)."""
    Ls, d, Us = split(LU)
    r = r.to(torch.float64)
    y = r
    for _ in range(sweeps):
        y = r - Ls @ y
    zr = y / d
    z = zr
    for _ in range(sweeps):
        z = zr - Us @ z
    return z


def exact_apply(LU: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(LU)⁻¹ r by two exact triangular solves (fp64)."""
    L = torch.tril(LU, -1) + torch.eye(LU.shape[0], dtype=torch.float64)
    U = torch.triu(LU)
    y = torch.linalg.solve_triangular(L, r.to(torch.float64)[:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(U, y, upper=True).flatten()


def block_jacobi(A: torch.Tensor, blocks: int, sweeps: int | None = None):
    """M⁻¹ of block-Jacobi ILU(0) on a dense n × n matrix cut into
    ``blocks`` equal diagonal blocks: the function r ↦ z and the blocks'
    packed factors.  ``sweeps``: the Neumann apply's steps, None for exact
    triangular solves."""
    n = A.shape[0]
    R = n // blocks
    factors = [ilu0(A[p * R:(p + 1) * R, p * R:(p + 1) * R]) for p in range(blocks)]

    def apply(r):
        parts = [r[p * R:(p + 1) * R] for p in range(blocks)]
        if sweeps is None:
            return torch.cat([exact_apply(F, x) for F, x in zip(factors, parts)])
        return torch.cat([neumann_apply(F, x, sweeps) for F, x in zip(factors, parts)])
    return apply, factors


def pcg(A: torch.Tensor, b: torch.Tensor, apply, rtol: float, maxit: int = 10000):
    """Preconditioned CG from x = 0 to ‖b − A·x‖ ≤ rtol·‖b‖ (fp64): (x,
    iterations)."""
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    r = b.clone()
    z = apply(r)
    p = z.clone()
    rz = torch.dot(r, z)
    stop = rtol * torch.linalg.vector_norm(b)
    for it in range(1, maxit + 1):
        q = A @ p
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        if torch.linalg.vector_norm(b - A @ x) <= stop:
            return x, it
        z = apply(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxit


def relres(A: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ in fp64."""
    b, x = b.to(torch.float64), x.to(torch.float64)
    return float(torch.linalg.vector_norm(b - A @ x) / torch.linalg.vector_norm(b))
