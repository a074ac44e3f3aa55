"""Device operations: the SpMV family (kernel K1 for DIA, K3 for HYB), the
per-shard DIA SpMV of the distributed solve (kernel K4), the triangular
solves, the Neumann ILU apply (kernel K2) and the BLAS-1 operations; each
kernel with its k-rhs form on (n, k) blocks (K1k-K4k, the layout
``ops/spmv.py`` states)."""

from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain, dia_spmv, dia_spmv_plain
from lssp_tpu_torch.ops.dia_spmv_ext import (
    dia_spmm_ext, dia_spmm_ext_plain, dia_spmv_ext, dia_spmv_ext_plain,
)
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain, hyb_spmv, hyb_spmv_plain
from lssp_tpu_torch.ops.neumann import (
    fused_neumann_apply, neumann_apply_plain, neumann_block_apply, plan_fused_neumann,
    plan_fused_neumann_t,
)
from lssp_tpu_torch.ops.spmv import (
    csr_row_ids, mv_amxpby, mv_amxpbyz, mv_amxy, mv_mxy, spmv, spmv_t,
)
from lssp_tpu_torch.ops.blas1 import axpby, axpbyz, axpy, dot, norm2
from lssp_tpu_torch.ops.trisolve import (
    TriSchedule, ilu_apply, level_schedule, make_ilu_apply, trisolve_lower_unit,
    trisolve_upper,
)

__all__ = ["dia_spmv", "dia_spmv_plain", "dia_spmm", "dia_spmm_plain",
           "dia_spmv_ext", "dia_spmv_ext_plain", "dia_spmm_ext", "dia_spmm_ext_plain",
           "hyb_spmv", "hyb_spmv_plain", "hyb_spmm", "hyb_spmm_plain",
           "fused_neumann_apply", "neumann_block_apply", "neumann_apply_plain",
           "plan_fused_neumann", "plan_fused_neumann_t", "spmv", "spmv_t", "mv_amxpby",
           "mv_amxpbyz", "mv_amxy", "mv_mxy", "csr_row_ids",
           "dot", "norm2", "axpy", "axpby", "axpbyz",
           "TriSchedule", "level_schedule", "trisolve_lower_unit", "trisolve_upper",
           "ilu_apply", "make_ilu_apply"]
