"""QMRCGSTAB (reference lssp_solver_qmrcgstab, solver-qmrcgstab.cxx:9-186):
iterates on the fully preconditioned system (r = M⁻¹(b − Ax), :84) with
two quasi-minimization sweeps an iteration (:111-121, :135-145); it stops
on the preconditioned relative residual and reports the true residual,
recomputed at exit (:153-157).  One body for the single-rhs and the
per-column batched form (``lanes``)."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("qmrcgstab")
@register_solver("qmrcgstab")
def qmrcgstab(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, t0 = init_state(A, b, x0, M)
    L = Lanes(b, t0, opts, dot=dot)
    tiny = torch.finfo(b.dtype).tiny
    # relative threshold on the preconditioned residual (:80 tol /= residual)
    L.tol = L.tol / np.maximum(L.r0norm, tiny)
    rk = br0 = pc(t0)
    tau = norm(rk, dot)
    (ires,) = L.read(tau)
    L.res = np.full(L.shape, np.inf)           # the loop runs while rerror > rtol alone
    L.active = L.it < L.limit
    pk = vk = dk = torch.zeros_like(b)
    rho_old = alpha = omega = L.scalar(1.0, b)
    theta = eta = L.scalar(0.0, b)
    while L.active.any():
        rho = dot(br0, rk)
        beta = rho * alpha / nonzero(rho_old * omega)
        pk = rk + beta * (pk - omega * vk)
        vk = pc(op(pk))
        alpha = rho / nonzero(dot(br0, vk))
        sk = rk - alpha * vk
        # first quasi-minimization
        btheta = norm(sk, dot) / nonzero(tau)
        c = 1.0 / torch.sqrt(1.0 + btheta * btheta)
        btau = tau * btheta * c
        b_eta = c * c * alpha
        bdk = pk + (theta * theta * eta / nonzero(alpha)) * dk
        bxk = x + b_eta * bdk
        tk = pc(op(sk))
        omega = dot(sk, tk) / nonzero(dot(tk, tk))
        rk = sk - omega * tk
        # second quasi-minimization
        rkn = norm(rk, dot)
        theta = rkn / nonzero(btau)
        c = 1.0 / torch.sqrt(1.0 + theta * theta)
        tau = btau * theta * c
        eta = c * c * omega
        dk = sk + (btheta * btheta * b_eta / nonzero(omega)) * bdk
        x = L.pick(L.active, bxk + eta * dk, x)
        (rkn_h,) = L.read(rkn)
        rerror = rkn_h / np.maximum(ires, tiny)
        L.advance(rerror, trace=rerror * ires)
        rho_old = rho
    (res,) = L.read(norm(b - op(x), dot))      # the true residual at exit (:153-157)
    return L.result(x, residual=res, converged=L.res <= L.tol)
