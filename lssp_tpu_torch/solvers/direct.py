"""Direct solves: ``direct`` / ``splu`` (x = x0 + M⁻¹(b − A·x0) with the
exact-LU preconditioner) and ``solve_lsq`` (direct least squares).

The port of ``lssp_tpu/solvers/direct.py``.  Capability parity with the
reference's direct-solver wrappers (UMFPACK solver-umfpack.cxx:107-153,
KLU solver-klu.cxx:8-41, SuperLU solver-superlu.cxx:28-85, MUMPS
solver-mumps.cxx:162-210, PARDISO solver-pardiso.cxx:10-116), which all
report nits=1 after one factored solve.  The facade installs ``pc="lu"``
for this method; through the ``Solver`` lifecycle the factorization is
cached across right-hand sides (the reference's ``factored`` flag,
solver-umfpack.cxx:43-44).  Unlike the reference (residual hardwired to 0,
solver-umfpack.cxx:150) the true residual is computed and reported.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.solvers.base import dot as base_dot, init_state, norm
from lssp_tpu_torch.solvers.lanes import Lanes
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


def solve_lsq(A, b, rtol: float = 1e-10, max_refine: int = 4, method: str = "qr",
              device=None):
    """Direct least squares: min ‖Ax − b‖₂ for a full-column-rank A (host
    CSR).  Returns (x, ‖Aᵀ(b − Ax)‖), x a float64 tensor on ``device``
    (``config.resolve_device``: b's device for a tensor b, else the current
    CUDA device).

    Capability parity with the reference's QR_MUMPS adapter
    (solver-qrmumps.cxx:10-84, sparse QR).  ``method="qr"`` (default): the
    host sparse QR (George–Heath Givens row merging, RCM column ordering,
    ``pc/qr_host.py``) with Qᵀb accumulated through the rotations, so the
    error scales with cond(A), not cond(A)²; under m·n ≤ 2e7 dense LAPACK
    QR instead.  ``method="normal"``: the normal equations AᵀA x = Aᵀb
    through the AMD sparse LU of AᵀA (its triangular sweeps on ``device``)
    plus ``max_refine`` refinement steps to ``rtol``, faster for large
    well-conditioned systems.  For iterative least squares use
    ``solve(method="lsqr")``.

    Rank-deficient systems do not raise: empty columns get unit diagonals
    (QR) and near-zero pivots are clamped (LU), giving *a* least-squares
    solution.  An underdetermined system (m < n) gets the MINIMUM-NORM
    solution on the qr route (a Q-less factorization of Aᵀ).  The QR and
    its solve are host numpy, as in JAX."""
    device = resolve_device(device, b)
    bn = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
          else np.asarray(b)).astype(np.float64)

    def out(x, As):
        return (torch.from_numpy(np.ascontiguousarray(x, np.float64)).to(device),
                float(np.linalg.norm(As.T @ (bn - As @ x))))

    if method == "qr":
        m, n = A.shape
        if m < n:
            # minimum-norm solution of the wide system via QR of the tall Aᵀ
            if m * n <= 2e7:
                As = A.to_scipy().tocsr().astype(np.float64)
                Q, R = np.linalg.qr(As.T.toarray())
                d = np.diag(R)
                Rs = R + np.diag(np.where(np.abs(d) == 0, 1.0, 0.0))
                return out(Q @ np.linalg.solve(Rs.T, bn), As)
            from lssp_tpu_torch.pc.qr_host import qr_factor, qr_solve_minnorm
            from lssp_tpu_torch.sparse.utils import transpose
            f = qr_factor(transpose(A))
            return out(qr_solve_minnorm(f, bn), f.A_scipy.T.tocsr())
        if m * n <= 2e7:
            # dense LAPACK QR: a sparse Givens QR of a random pattern fills
            # R near-dense anyway (its win is large structured systems)
            As = A.to_scipy().tocsr().astype(np.float64)
            Q, R = np.linalg.qr(As.toarray())
            x = np.linalg.solve(R + np.diag(np.where(np.abs(np.diag(R)) == 0, 1.0, 0.0)),
                                Q.T @ bn)
            return out(x, As)
        from lssp_tpu_torch.pc.qr_host import qr_factor, qr_solve
        f = qr_factor(A, b=bn)
        return out(qr_solve(f), f.A_scipy)

    from lssp_tpu_torch.pc.lu import _lu_apply, lu_state
    from lssp_tpu_torch.pc.lu_host import splu_factor
    from lssp_tpu_torch.sparse.types import CSR

    As = A.to_scipy().tocsr().astype(np.float64)
    G = (As.T @ As).tocsr()
    state = lu_state(splu_factor(CSR.from_scipy(G), order="amd"), np.float64, device)

    def gsolve(r):
        return _lu_apply(state, torch.from_numpy(r).to(device)).cpu().numpy()

    atb = As.T @ bn
    x = gsolve(atb)
    res = atb - G @ x
    scale = max(1.0, float(np.linalg.norm(atb)))
    for _ in range(max_refine):
        if np.linalg.norm(res) <= rtol * scale:
            break
        x = x + gsolve(res)
        res = atb - G @ x
    return out(x, As)


@register_solver("direct", "splu")
@register_batched("direct", "splu")
def direct(A, b, x0=None, M=None, opts=None, dot=base_dot):
    """One exact solve: x = x0 + M⁻¹(b − A·x0), nits = 1, the true residual
    ‖b − Ax‖ reported.  ``b`` (n,), or an (n, k) block (``solve_multi``:
    M applied once to the residual block, the (k,) fields per column)."""
    if M is None:
        raise ValueError('method="direct" needs an exact preconditioner; use '
                         'solve(..., method="direct") (the facade installs pc="lu") '
                         'or pass M explicitly')
    op, pc, x, r = init_state(A, b, x0, M)
    lanes = Lanes(b, r, opts, it0=1, dot=dot)
    x = x + pc(r)
    (res,) = lanes.read(norm(b - op(x), dot))
    return lanes.result(x, residual=res)
