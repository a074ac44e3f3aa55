"""Polynomial (Chebyshev) preconditioner, ``poly`` and ``chebyshev``
(``lssp_tpu/pc/poly.py``): M⁻¹ ≈ p(A), the degree-d Chebyshev polynomial
minimizing ‖1 − λ·p(λ)‖ over [λmax/ratio, 1.05·λmax], with λmax from a
host power iteration at setup (``default_rng(0)``, as in JAX).  For SPD
systems.  The apply is d products and axpys: kernel K1 on a DIA matrix
(K1k on a block) on the card.  p(A)ᵀ = p(Aᵀ), so the transpose apply runs
the same recurrence on ``spmv_t``."""
from __future__ import annotations

import functools

import numpy as np
import torch

from lssp_tpu_torch.ops.spmv import spmv, spmv_t
from lssp_tpu_torch.pc.base import Preconditioner, register_pc
from lssp_tpu_torch.sparse.convert import to_device_format
from lssp_tpu_torch.sparse.types import CSR


def _power_lmax(A: CSR, iters: int = 20) -> float:
    """1.1 × the largest |eigenvalue| estimate of 20 power steps."""
    rng = np.random.default_rng(0)
    S = A.to_scipy()
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = S @ v
        lam = float(np.linalg.norm(w))
        if lam == 0:
            return 1.0
        v = w / lam
    return 1.1 * lam


def _poly_apply(degree, lb, ub, A, r, transpose=False):
    """z = p(A)·r: ``degree`` steps of the Chebyshev iteration for A z = r
    from z = 0 over [lb, ub]; ``transpose`` runs p(Aᵀ).  r is (n,) or an
    (n, k) block."""
    product = spmv_t if transpose else spmv
    theta, delta = (ub + lb) / 2.0, (ub - lb) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    z = torch.zeros_like(r)
    res = r
    d = res / theta
    for _ in range(degree):
        z = z + d
        res = res - product(A, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return z


@register_pc("poly")
def setup_poly(A, opts, device):
    if opts.poly_degree < 1:
        raise ValueError(f"poly PC requires poly_degree >= 1, got {opts.poly_degree}")
    ub = 1.05 * _power_lmax(A)
    lb = ub / max(opts.poly_ratio, 1.0 + 1e-6)
    d = int(opts.poly_degree)
    # the solver's own format rule, so that a banded A runs on K1 here too
    return Preconditioner(functools.partial(_poly_apply, d, lb, ub),
                          state=to_device_format(A, device=device),
                          name=f"poly(d={opts.poly_degree})",
                          apply_t_fn=functools.partial(_poly_apply, d, lb, ub, transpose=True))


register_pc("chebyshev")(setup_poly)
