"""ORTHOMIN(k) (reference lssp_solver_orthomin, solver-orthomin.cxx:12-180):
a truncated history of k = restart directions (:70-75) in a ring (:102,
138); every iteration recomputes the true residual (:140), and
|⟨q, q⟩| ≤ breakdown stops with x unchanged.  One body for the single-rhs
and the per-column batched form (``lanes``)."""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("orthomin")
@register_solver("orthomin")
def orthomin(A, b, x0=None, M=None, opts=None, dot=base_dot):
    k = opts.restart
    op, pc, x, z0 = init_state(A, b, x0, M)
    L = Lanes(b, z0, opts, dot=dot)
    r = sd = pc(z0)
    P, Q, C = [r] + [None] * (k - 1), [None] * k, [None] * k
    it = 0
    while L.active.any():
        j = it % k
        qj = pc(op(sd))
        cj = dot(qj, qj)
        a = dot(r, qj) / cj
        C[j], Q[j] = cj, qj
        x_new = x + a * P[j]
        res, cj_h = L.read(norm(b - op(x_new), dot), cj)
        brk = np.abs(cj_h) <= opts.breakdown
        x = L.pick(L.active & ~brk, x_new, x)
        L.advance(np.where(brk, L.res, res), done=brk)
        if L.active.any():
            r = r - a * qj
            z = pc(op(r))
            sd = r
            for i in range(min(it + 1, k)):  # project against the live directions
                sd = sd - (dot(z, Q[i]) / C[i]) * P[i]
            P[(it + 1) % k] = sd
        it += 1
    return L.result(x)
