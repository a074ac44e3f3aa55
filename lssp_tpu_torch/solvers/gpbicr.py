"""GPBiCR (reference lssp_solver_gpbicr, solver-gpbicr.cxx:4-164): the CR
analog of GPBiCG, with shadow r̃ = A·r0 and ρ = ⟨r̃, M⁻¹r⟩; the body is
``gpbicg.gpbi``."""
from __future__ import annotations

from lssp_tpu_torch.solvers.base import dot as base_dot
from lssp_tpu_torch.solvers.gpbicg import gpbi
from lssp_tpu_torch.solvers.registry import register_batched, register_solver


@register_batched("gpbicr")
@register_solver("gpbicr")
def gpbicr(A, b, x0=None, M=None, opts=None, dot=base_dot):
    return gpbi(A, b, x0, M, opts, cr=True, dot=dot)
