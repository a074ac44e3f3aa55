"""lssp_tpu_torch — the sparse linear solvers of ``lssp_tpu``, ported to
PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``lssp_tpu`` is the reference; this package imports
neither it nor JAX.  The solve path runs on CPU tensors through plain
PyTorch and on CUDA tensors through four hand-written kernels: the DIA
stencil SpMV (``ops/dia_spmv.py``, K1), the Neumann ILU sweep
(``ops/neumann.py``, K2), the HYB band-plus-remainder SpMV
(``ops/hyb_spmv.py``, K3) and the per-shard DIA SpMV of the distributed
solve (``ops/dia_spmv_ext.py``, K4; ``parallel/``, over the ranks of a
``torch.distributed`` group through ``parallel/multihost.py``, one process
per device), each with a k-rhs form
(K1k-K4k) for the multi-rhs path (``solve_multi``, ``solve_ir_multi``,
``dist_solve_multi``, ``dist_solve_ir_multi``; B is (n, k)).  The AMG
preconditioners ``amg``, ``saamg`` and ``rsamg`` (``amg/``) run their
cycles on the same kernels, and ``amg_solve`` is the standalone AMG solver;
over a shard mesh they run as distributed hierarchies (``parallel/``,
every banded level product on K4).  Block matrices (``BSR``) run as
scalar DIA on K1 where their diagonals allow, with the block-ILU family
``biluk``, ``bilut``, ``vbiluk`` and ``vbilut`` (``pc/biluk.py``).  The
direct solvers (``method="direct"`` / ``"splu"``, the ``lu`` PC: AMD
ordering, Gilbert–Peierls or supernodal multifrontal LU on the host, exact
level-scheduled sweeps on the device) and ``solve_lsq`` (sparse QR or the
normal equations) need no kernel beyond the residual products.

Entry points run on the current CUDA device unless given a CPU tensor or
``device="cpu"``; without a CUDA device they raise rather than fall back.

    >>> import torch, lssp_tpu_torch as lt
    >>> A = lt.sparse.laplacian_3d(64)              # host CSR
    >>> b = torch.ones(A.shape[0], dtype=torch.float64, device="cuda")
    >>> x, info = lt.solve_ir(A, b, method="cg", pc="ilu0")
    >>> B = torch.randn(A.shape[0], 8, dtype=torch.float64, device="cuda")
    >>> X, info = lt.solve_ir_multi(A, B, method="blockcg", pc="ilu0")
"""

from lssp_tpu_torch import amg, ops, parallel, pc, solvers, sparse
from lssp_tpu_torch.amg import amg_solve
from lssp_tpu_torch.config import Defaults, PCOptions, SolverOptions
from lssp_tpu_torch.parallel import (
    dist_solve, dist_solve_ir, dist_solve_ir_multi, dist_solve_multi, make_mesh,
)
from lssp_tpu_torch.solvers import (
    SolveInfo, Solver, prepare_ir, solve, solve_ir, solve_ir_multi, solve_lsq, solve_multi,
)
from lssp_tpu_torch.sparse import BDIA, BSR, COO, CSR, DIA, ELL, HYB

__version__ = "0.1.0"

__all__ = [
    "sparse", "ops", "parallel", "solvers", "pc", "amg", "amg_solve",
    "SolverOptions", "PCOptions", "Defaults",
    "solve", "solve_ir", "prepare_ir", "Solver", "SolveInfo",
    "solve_multi", "solve_ir_multi", "solve_lsq",
    "dist_solve", "dist_solve_ir", "dist_solve_multi", "dist_solve_ir_multi", "make_mesh",
    "BDIA", "BSR", "COO", "CSR", "DIA", "ELL", "HYB",
]
