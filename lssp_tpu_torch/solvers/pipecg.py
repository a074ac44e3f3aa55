"""Pipelined (single-reduction) Conjugate Gradient, Ghysels–Vanroose /
Chronopoulos–Gear PCG (``lssp_tpu/solvers/pipecg.py``).

Mathematically CG (``solvers/cg.py``), restructured so that an iteration
has one synchronization point: γ = ⟨r, u⟩, δ = ⟨w, u⟩ and ‖r‖² are one
``dot_many`` (on a shard mesh one reduction over the shards,
``parallel/dist_ops.make_psum_dot``), and every vector update hangs off a
recurrence.  ‖r‖ is thus known one reduction late: the loop runs one
more body than cg (counts cg's ±1), and the reported residual is the exact
norm of the final r.  No reference analog (the reference is serial).  One
body for the single-rhs and the per-column batched form (``lanes``); ``dot``
is the solve's inner product (``base.dot``, or the distributed one).
"""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, dot_many, init_state, nonzero
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("pipecg")
@register_solver("pipecg")
def pipecg(A, b, x0=None, M=None, opts=None, dot=base_dot):
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, dot=dot)
    L.rel = True
    u = pc(r)
    w = op(u)
    z = q = s = p = torch.zeros_like(r)
    gamma_old = alpha_old = None
    while L.active.any():
        # the one synchronization point: three reductions together
        gamma, delta, rr = dot_many(dot, ((r, u), (w, u), (r, r)))
        m = pc(w)
        nv = op(m)
        if gamma_old is None:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / nonzero(alpha_old))
        z = nv + beta * z           # = A M⁻¹ s
        q = m + beta * q            # = M⁻¹ s
        s = w + beta * s            # = A p
        p = u + beta * p
        x_new = x + alpha * p
        r_new = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        # rr is ‖r‖² of the r that entered this iteration
        (res,) = L.read(torch.sqrt(rr))
        x = L.pick(L.active, x_new, x)
        r = L.pick(L.active, r_new, r)
        L.advance(res)
        gamma_old, alpha_old = gamma, alpha
    # the merged reduction measured the r that entered the last iteration:
    # report the exact norm of the final one
    (res,) = L.read(torch.sqrt(dot(r, r)))
    return L.result(x, residual=res)
