"""The distributed solve on a shard mesh: row partitioning
(``partition.py``), the halo-exchange products and shard reductions
(``dist_ops.py``, kernel K4 for every DIA band, K4k on blocks),
``dist_solve`` / ``dist_solve_ir`` with their multi-rhs forms
``dist_solve_multi`` / ``dist_solve_ir_multi`` (``dist_solve.py``), and
the distributed AMG hierarchies: structured SA (``dist_sa.py``), classical
through the same cycle (``dist_rs.py``) and classical on padded ELL
(``dist_amg.py``), each built whole on the host and cut to a rank's
shards, and the multi-process runtime, one rank per device
(``multihost.py``), over which every preconditioner runs."""

from lssp_tpu_torch.parallel import multihost
from lssp_tpu_torch.parallel.dist_amg import DistAMG, build_dist_amg, dist_vcycle
from lssp_tpu_torch.parallel.dist_ops import (
    apply_dist_spmv, halo_exchange, make_dist_spmv, make_psum_dot,
)
from lssp_tpu_torch.parallel.dist_solve import (
    Mesh, dist_solve, dist_solve_ir, dist_solve_ir_multi, dist_solve_multi, make_mesh,
)
from lssp_tpu_torch.parallel.dist_rs import build_dist_rs
from lssp_tpu_torch.parallel.dist_sa import DistSA, build_dist_sa, dist_sa_vcycle
from lssp_tpu_torch.parallel.partition import (
    DistDIA, DistELL, DistHYB, partition_csr, partition_csr_dia, partition_csr_hyb,
    partition_matrix, shard_vector, unshard_vector,
)

__all__ = ["DistAMG", "DistDIA", "DistELL", "DistHYB", "DistSA", "Mesh", "apply_dist_spmv",
           "build_dist_amg", "build_dist_rs", "build_dist_sa", "dist_sa_vcycle", "dist_solve",
           "dist_solve_ir", "dist_solve_ir_multi", "dist_solve_multi", "dist_vcycle",
           "halo_exchange",
           "make_dist_spmv", "make_mesh", "make_psum_dot", "multihost", "partition_csr",
           "partition_csr_dia",
           "partition_csr_hyb", "partition_matrix", "shard_vector", "unshard_vector"]
