"""BLAS-1 vector operations (``lssp_tpu/ops/blas1.py``; reference
reference src/vector.cxx:31-146), for API parity.  ``dot`` and
``norm2`` go through ``solvers/base.dot``, the port's one reduction order
(fixed pairwise on the CPU for any thread count, cuBLAS on the card)."""
from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> (vector.cxx lssp_vec_dot)."""
    from lssp_tpu_torch.solvers.base import dot as base_dot
    return base_dot(x, y)


def norm2(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 (vector.cxx lssp_vec_norm)."""
    return torch.sqrt(dot(x, x))


def axpy(alpha, x, y):
    """y + alpha*x."""
    return y + alpha * x


def axpby(alpha, x, beta, y):
    """beta*y + alpha*x (vector.cxx lssp_vec_axpby)."""
    return beta * y + alpha * x


def axpbyz(alpha, x, beta, y):
    """z = beta*y + alpha*x (vector.cxx lssp_vec_axpbyz)."""
    return beta * y + alpha * x
