"""FGMRES(m) — flexible GMRES (Saad 1993), as in the reference's PETSc
adapter table (solver-petsc.cxx:23-32): right-preconditioned Arnoldi
that keeps Z[i] = M⁻¹v_i, so the preconditioner may change every step;
x += Z·y, and the true residual at every restart.  ``solve_ir`` runs
``rgmres`` in its place (the same method for a fixed preconditioner).

One body for the single-rhs and the per-column batched form (``lanes``),
on ``lgmres.arnoldi``'s cycle."""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, norm
from lssp_tpu_torch.solvers.lanes import Lanes, combine
from lssp_tpu_torch.solvers.lgmres import arnoldi, solve_ym
from lssp_tpu_torch.solvers.registry import register_batched, register_solver
from lssp_tpu_torch.sparse.types import numpy_dtype


@register_batched("fgmres")
@register_solver("fgmres")
def fgmres(A, b, x0=None, M=None, opts=None, dot=base_dot):
    m = opts.restart
    op, pc, x, rg = init_state(A, b, x0, M)
    L = Lanes(b, rg, opts, dot=dot)
    dt = numpy_dtype(b.dtype).type
    tol = L.tol.astype(dt)
    tiny = torch.finfo(b.dtype).tiny
    while L.active.any():
        live = L.active
        bp_t = norm(rg, dot)
        v0 = rg / torch.clamp(bp_t, min=tiny)
        (bp,) = L.read(bp_t)
        Z = b.new_zeros((m,) + tuple(b.shape))

        def column(i, V):
            Z[i] = pc(V[i])
            return op(Z[i])

        V, H, gg, kk, itr, gs = arnoldi(column, v0, bp.astype(dt), m, L.it, opts.maxit, tol,
                                        opts.breakdown, live, check_maxit=True, discard=False,
                                        dot=dot)
        nv = int(kk.max())
        x = L.pick(live, x + combine(solve_ym(H, gg, kk, m, L.shape, b)[:nv], Z[:nv]), x)
        rg = b - op(x)
        (res,) = L.read(norm(rg, dot))          # the true residual each restart
        L.it = np.where(live, itr, L.it)
        L.res = np.where(live, res, L.res)
        L.record(live)
        L.settle()
    return L.result(x)
