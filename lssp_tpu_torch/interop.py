"""Carry state from the JAX package across, as numpy arrays.

Each function takes the fields of an ``lssp_tpu`` container (after
``np.asarray``) and builds the matching container here.  Nothing here
imports JAX: the caller converts.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.sparse.types import CSR, DIA


def csr_from_arrays(indptr, indices, data, shape) -> CSR:
    """A host CSR from ``lssp_tpu.sparse.CSR`` fields."""
    return CSR(np.asarray(indptr, dtype=np.int32), np.asarray(indices, dtype=np.int32),
               np.asarray(data), (int(shape[0]), int(shape[1])))


def dia_from_arrays(offsets, data, shape, device="cpu") -> DIA:
    """A DIA on ``device`` from ``lssp_tpu.sparse.DIA`` fields (offsets, the
    (ndiag, n) data, shape)."""
    return DIA(tuple(int(o) for o in offsets),
               torch.from_numpy(np.ascontiguousarray(data)).to(device),
               (int(shape[0]), int(shape[1])))


def ilu_factors_from_arrays(L_arrays, U_arrays):
    """(L, U) host factors from ``(indptr, indices, data, shape)`` tuples of
    the JAX package's ILU factors (L strictly lower, U upper with the
    diagonal)."""
    return csr_from_arrays(*L_arrays), csr_from_arrays(*U_arrays)
