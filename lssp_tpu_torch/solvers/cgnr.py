"""CGNR / CGN — conjugate gradients on the normal equations AᵀAx = Aᵀb,
the reference's LASPACK adapter method (solver-laspack.cxx:29-34;
``lssp_tpu/solvers/cgnr.py``): one product and one Aᵀ·v an iteration,
stopping on the true residual ‖b − Ax‖.  A given M is a right
preconditioner: CGNR on A·M⁻¹ through M⁻ᵀ, then x = x0 + M⁻¹y.  A lane
stops when ‖Aᵀr‖² falls to the breakdown threshold.

One body for the single-rhs and the per-column batched form (``lanes``):
each iteration reads ‖r‖ and ‖z‖² in one transfer; a stopped lane keeps
its y."""
from __future__ import annotations

import torch

from lssp_tpu_torch.solvers.base import (
    dot as base_dot, identity_pc, nonzero, norm, operator, operator_t, pc_transpose,
)
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("cgnr", "cgn")
@register_solver("cgnr", "cgn")
def cgnr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    a_op, a_opt = operator(A), operator_t(A)
    if M is None:
        op, opt, pc = a_op, a_opt, identity_pc
    else:
        pct = pc_transpose(M)
        op, opt, pc = (lambda v: a_op(M(v))), (lambda v: pct(a_opt(v))), M
    # y iterates with x = x0 + M⁻¹y; without M, y starts at x0 itself
    y = torch.zeros_like(b) if x0 is None or M is not None else x0
    r = b - a_op(x0) if x0 is not None else b - 0.0 * b
    L = Lanes(b, r, opts, dot=dot)
    L.rel = True
    z = opt(r)
    p, zn2 = z, dot(z, z)
    (zn2_h,) = L.read(zn2)
    L.settle(zn2_h <= opts.breakdown)
    while L.active.any():
        w = op(p)
        alpha = zn2 / nonzero(dot(w, w))
        y = L.pick(L.active, y + alpha * p, y)
        r = r - alpha * w
        z = opt(r)
        zn2_new = dot(z, z)
        p = z + (zn2_new / nonzero(zn2)) * p
        zn2 = zn2_new
        res, zn2_h = L.read(norm(r, dot), zn2)
        L.advance(res, done=zn2_h <= opts.breakdown)
    if M is None:
        return L.result(y)
    return L.result(pc(y) if x0 is None else x0 + pc(y))
