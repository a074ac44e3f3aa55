"""Sparse containers and host-side tooling: ``COO``, ``CSR`` and ``BSR``
(numpy, for assembly and factorization), ``DIA``, ``HYB``, ``ELL`` and
``BDIA`` (tensors, the execution formats), MatrixMarket I/O and the bandwidth-reducing reorder."""

from lssp_tpu_torch.sparse.types import BDIA, BSR, COO, CSR, DIA, ELL, HYB
from lssp_tpu_torch.sparse.convert import (
    band_occupancy, bsr_to_bdia, bsr_to_csr, coo_to_csr, csr_entry_offsets, csr_to_bsr,
    csr_to_coo, csr_to_dia, csr_to_ell, csr_to_hyb, to_device_format,
)
from lssp_tpu_torch.sparse.utils import (
    adjust_zero_diag, block_diag_extract, diagonal, is_sorted, sort_columns, split_ldu,
    split_lu, transpose,
)
from lssp_tpu_torch.sparse.generators import (
    anisotropic_poisson_2d, convection_diffusion_2d, elasticity_2d,
    laplacian_2d, laplacian_3d, random_sparse,
)
from lssp_tpu_torch.sparse.io import read_matrix_market, write_matrix_market
from lssp_tpu_torch.sparse.reorder import (
    band_coverage, bandwidth, grid_transpose_perm, maybe_rcm, num_diagonals,
    permute_symmetric, rcm_permutation,
)

__all__ = [
    "BDIA", "BSR", "COO", "CSR", "DIA", "ELL", "HYB",
    "band_occupancy", "bsr_to_bdia", "bsr_to_csr", "coo_to_csr", "csr_entry_offsets",
    "csr_to_bsr", "csr_to_coo", "csr_to_dia", "csr_to_ell", "csr_to_hyb", "to_device_format",
    "adjust_zero_diag", "block_diag_extract", "diagonal", "is_sorted", "sort_columns",
    "split_ldu", "split_lu", "transpose",
    "anisotropic_poisson_2d", "convection_diffusion_2d", "elasticity_2d",
    "laplacian_2d", "laplacian_3d", "random_sparse",
    "read_matrix_market", "write_matrix_market",
    "band_coverage", "bandwidth", "grid_transpose_perm", "maybe_rcm", "num_diagonals",
    "permute_symmetric", "rcm_permutation",
]
