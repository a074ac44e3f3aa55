"""Krylov solvers (cg, gmres, rgmres, bicgstab, cgs, cr, crs, bicrstab,
bicgsafe, bicrsafe, gpbicg, gpbicr, qmrcgstab, tfqmr, orthomin, bicgstabl,
idrs, lgmres, rlgmres, minres, fgmres, bicg, qmr, cgnr / cgn, lsqr,
pipecg, cagmres and cargmres), the direct solve (direct / splu), each with
its per-column batched form, the block methods blockcg and blockgmres,
direct least squares (``solve_lsq``), the solve facade and mixed-precision
iterative refinement, single- and multi-rhs."""

from lssp_tpu_torch.solvers.base import SolveInfo
from lssp_tpu_torch.solvers.registry import (
    BATCHED_SOLVERS, SOLVERS, get_batched_solver, get_block_solver, get_solver,
    register_solver,
)
from lssp_tpu_torch.solvers.facade import Solver, solve, solve_multi, validate_system
from lssp_tpu_torch.solvers.refine import prepare_ir, solve_ir, solve_ir_multi
from lssp_tpu_torch.solvers.direct import solve_lsq

__all__ = ["SolveInfo", "SOLVERS", "BATCHED_SOLVERS", "get_solver", "get_batched_solver",
           "get_block_solver", "register_solver", "Solver", "solve", "solve_multi",
           "validate_system", "prepare_ir", "solve_ir", "solve_ir_multi", "solve_lsq"]
