"""Krylov solvers (cg, gmres, rgmres, bicgstab), the solve facade and
mixed-precision iterative refinement."""

from lssp_tpu_torch.solvers.base import SolveInfo
from lssp_tpu_torch.solvers.registry import SOLVERS, get_solver, register_solver
from lssp_tpu_torch.solvers.facade import Solver, solve, validate_system
from lssp_tpu_torch.solvers.refine import prepare_ir, solve_ir

__all__ = ["SolveInfo", "SOLVERS", "get_solver", "register_solver", "Solver",
           "solve", "validate_system", "prepare_ir", "solve_ir"]
