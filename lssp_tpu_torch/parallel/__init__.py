"""The distributed solve on a shard mesh: row partitioning
(``partition.py``), the halo-exchange products and shard reductions
(``dist_ops.py``, kernel K4 for every DIA band, K4k on blocks) and
``dist_solve`` / ``dist_solve_ir`` with their multi-rhs forms
``dist_solve_multi`` / ``dist_solve_ir_multi`` (``dist_solve.py``)."""

from lssp_tpu_torch.parallel.dist_ops import (
    apply_dist_spmv, halo_exchange, make_dist_spmv, make_psum_dot,
)
from lssp_tpu_torch.parallel.dist_solve import (
    Mesh, dist_solve, dist_solve_ir, dist_solve_ir_multi, dist_solve_multi, make_mesh,
)
from lssp_tpu_torch.parallel.partition import (
    DistDIA, DistELL, DistHYB, partition_csr, partition_csr_dia, partition_csr_hyb,
    partition_matrix, shard_vector, unshard_vector,
)

__all__ = ["DistDIA", "DistELL", "DistHYB", "Mesh", "apply_dist_spmv", "dist_solve",
           "dist_solve_ir", "dist_solve_ir_multi", "dist_solve_multi", "halo_exchange",
           "make_dist_spmv", "make_mesh", "make_psum_dot", "partition_csr", "partition_csr_dia",
           "partition_csr_hyb", "partition_matrix", "shard_vector", "unshard_vector"]
