"""GPBiCG (reference lssp_solver_gpbicg, solver-gpbicg.cxx:4-163): the
product-type method with the (ζ, η) pair of BiCGSafe's five dots (:85-98)
and the mid-step exit on t = r − α·Ap (:70-79: x += αp, residual t).  The
breakdown exits are ⟨r̃, Ap⟩ == 0 and ρ == 0.  ``gpbicr`` runs the same
body as its CR analog.  One body for the single-rhs and the per-column
batched form (``lanes``): each iteration reads ⟨r̃, Ap⟩, ‖t‖, the full
step's ‖r‖ and the next ρ in one transfer."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, nonzero, norm
from lssp_tpu_torch.solvers.bicgsafe import qsi_eta
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


def gpbi(A, b, x0, M, opts, cr: bool, dot):
    """GPBiCG, or with ``cr`` GPBiCR (reference solver-gpbicr.cxx:4-164):
    shadow r̃ = A·r0 and every ρ = ⟨r̃, M⁻¹·⟩."""
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    p = mr = pc(r)
    rtld = op(r) if cr else r
    rho_old = dot(rtld, p if cr else r)
    t = w = z = u = mt_old = torch.zeros_like(r)
    beta = L.scalar(0.0, b)
    first = True
    while L.active.any():
        ap = op(p)
        map_ = pc(ap)
        d0 = dot(rtld, map_ if cr else ap)
        alpha = rho_old / nonzero(d0)
        y = t - r + alpha * (ap - w)
        t = r - alpha * ap
        mt = mr - alpha * map_
        amt = op(mt)
        qsi, eta = qsi_eta(first, y, amt, t, dot)
        u = eta * (beta * u + mt_old - mr) + qsi * map_      # (:103-106)
        z = eta * z + qsi * mr - alpha * u
        x_half = x + alpha * p
        x_full = x_half + z
        r_full = t - qsi * amt - eta * y
        mr_full = pc(r_full) if cr else None
        rho = dot(rtld, mr_full if cr else r_full)
        d0_h, tnorm, rnorm, rho_h = L.read(d0, norm(t, dot), norm(r_full, dot), rho)
        fail = d0_h == 0.0
        early = tnorm <= L.tol              # ‖t‖ converged: x += αp, and stop
        go = L.active & ~fail
        x = L.pick(go & early, x_half, L.pick(go, x_full, x))
        res = np.where(early, tnorm, np.where(fail, L.res, rnorm))
        L.advance(res, done=fail | early | (rho_h == 0.0))
        if L.active.any():
            mr = mr_full if cr else pc(r_full)
            beta = (rho / nonzero(rho_old)) * (alpha / nonzero(qsi))
            w = amt + beta * ap
            p = mr + beta * (p - u)
        r, mt_old, rho_old, first = r_full, mt, rho, False
    return L.result(x)


@register_batched("gpbicg")
@register_solver("gpbicg")
def gpbicg(A, b, x0=None, M=None, opts=None, dot=base_dot):
    return gpbi(A, b, x0, M, opts, cr=False, dot=dot)
