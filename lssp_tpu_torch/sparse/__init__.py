"""Sparse containers and host-side tooling: ``COO`` and ``CSR`` (numpy, for
assembly and factorization), ``DIA`` and ``ELL`` (tensors, the execution
formats)."""

from lssp_tpu_torch.sparse.types import COO, CSR, DIA, ELL
from lssp_tpu_torch.sparse.convert import (
    coo_to_csr, csr_entry_offsets, csr_to_dia, csr_to_ell, to_device_format,
)
from lssp_tpu_torch.sparse.utils import (
    adjust_zero_diag, diagonal, is_sorted, sort_columns, split_ldu, split_lu,
    transpose,
)
from lssp_tpu_torch.sparse.generators import (
    anisotropic_poisson_2d, convection_diffusion_2d, elasticity_2d,
    laplacian_2d, laplacian_3d, random_sparse,
)

__all__ = [
    "COO", "CSR", "DIA", "ELL",
    "coo_to_csr", "csr_entry_offsets", "csr_to_dia", "csr_to_ell",
    "to_device_format",
    "adjust_zero_diag", "diagonal", "is_sorted", "sort_columns", "split_ldu",
    "split_lu", "transpose",
    "anisotropic_poisson_2d", "convection_diffusion_2d", "elasticity_2d",
    "laplacian_2d", "laplacian_3d", "random_sparse",
]
