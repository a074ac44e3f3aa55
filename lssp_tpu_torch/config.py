"""Runtime defaults and option dataclasses.

A field-for-field copy of ``lssp_tpu/config.py``, so that one options object
means the same in both packages.  The reference keeps mutable global
defaults (reference lssp.cxx:5-14, pc.cxx:3-7) that solvers fall back to
when a per-solver value is unset or negative; here the same table lives in
frozen dataclasses, and an unset field (``None`` or negative) resolves to
the default at solve time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


class Defaults:
    """Global defaults, mirroring the reference's lssp.cxx:5-14."""

    RESTART = 50        # LSSP_RESTART
    AUG_K = 3           # LSSP_AUG_K     (LGMRES augmentation depth)
    BGSL = 4            # LSSP_BGSL      (BiCGSTAB(l) polynomial degree)
    IDRS = 4            # LSSP_IDRS      (IDR(s) shadow-space size)
    MAXIT = 1000        # LSSP_MAXIT
    ATOL = 1e-7         # LSSP_ATOL
    RTOL = 1e-7         # LSSP_RTOL
    RBTOL = 1e-7        # LSSP_RB  (residual / ||b|| tolerance)
    BREAKDOWN = 1e-40   # LSSP_BREAKDOWN

    # Preconditioner defaults, reference pc.cxx:3-7.
    ILUK_LEVEL = 1          # lssp_pc_iluk_level_default
    ILUT_TOL = 1e-3         # lssp_pc_ilut_tol
    ILUT_P = -1             # lssp_pc_ilut_p  (-1 => auto: avg nnz/row)
    ZERO_DIAG_VALUE = 1e-3  # mat_zero_diag_value
    ZERO_DIAG_TOL = 1e-10   # mat_zero_diag_tol


def resolve_device(device, b=None) -> torch.device:
    """The device rule of every entry point: an explicit ``device`` wins, a
    tensor ``b`` gives its own, otherwise the current CUDA device; without
    a CUDA device that is an error, never a quiet CPU run.  An index-less
    ``"cuda"`` gets the current device's index, so that one card has one
    name (``str()`` of it keys the memos)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if isinstance(b, torch.Tensor):
        return b.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the solve runs on the card unless asked "
                           "otherwise; pass device=\"cpu\" (or a CPU tensor) to solve "
                           "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _resolve(value, default):
    """Reference convention: unset/negative falls back to the global default."""
    if value is None:
        return default
    if isinstance(value, (int, float)) and value < 0:
        return default
    return value


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Per-solve options (the reference's LSSP_SOLVER fields and setters)."""

    rtol: Optional[float] = None       # relative tolerance (vs ||r0||)
    atol: Optional[float] = None       # absolute tolerance
    rbtol: Optional[float] = None      # tolerance relative to ||b||
    maxit: Optional[int] = None
    restart: Optional[int] = None      # GMRES/ORTHOMIN restart / truncation
    aug_k: Optional[int] = None        # LGMRES augmentation vectors
    bgsl: Optional[int] = None         # BiCGSTAB(l) degree
    idrs: Optional[int] = None         # IDR(s) shadow dimension
    breakdown: Optional[float] = None
    verbosity: int = 0                 # 0 silent; >=1 per-iteration prints
    record_history: bool = False       # keep per-iteration residual trace
    dtype: Any = None                  # None => inherit from inputs

    def resolved(self) -> "SolverOptions":
        d = Defaults
        return dataclasses.replace(
            self,
            rtol=_resolve(self.rtol, d.RTOL),
            atol=_resolve(self.atol, d.ATOL),
            rbtol=_resolve(self.rbtol, d.RBTOL),
            maxit=int(_resolve(self.maxit, d.MAXIT)),
            restart=int(_resolve(self.restart, d.RESTART)),
            aug_k=int(_resolve(self.aug_k, d.AUG_K)),
            bgsl=int(_resolve(self.bgsl, d.BGSL)),
            idrs=int(_resolve(self.idrs, d.IDRS)),
            breakdown=_resolve(self.breakdown, d.BREAKDOWN),
        )


@dataclasses.dataclass(frozen=True)
class PCOptions:
    """Preconditioner options (the reference's LSSP_PC fields).  Fields of
    preconditioners this package does not carry yet (block ILU, ARMS,
    Schwarz, polynomial, direct LU, AMG) are kept so that an options object
    built for ``lssp_tpu`` means the same here."""

    iluk_level: Optional[int] = None      # ILU(k) fill level
    ilut_tol: Optional[float] = None      # ILUT drop tolerance
    ilut_p: Optional[int] = None          # ILUT max fill per row (-1 = auto)
    ilutp_permtol: float = 0.1            # ILUTP pivot threshold
    num_blocks: Optional[int] = None      # block count for block-Jacobi ILU
    block_size: Optional[int] = None      # uniform block size for BSR paths
    block_sizes: Any = None               # variable block sizes
    ilu_sweeps: Optional[int] = None      # triangular-solve strategy:
                                          # None = auto (6 Neumann sweeps on
                                          # CUDA, exact level scheduling on
                                          # the CPU); 0 = force exact (level
                                          # loop); -1 = exact via the
                                          # COMPLETE Neumann series; k>0 = k
                                          # sweeps
    omega: float = 1.0                    # damping (Jacobi/smoothers)
    poly_degree: int = 8                  # polynomial-PC Chebyshev degree
    poly_ratio: float = 30.0              # covered spectrum ratio (SPD)
    lu_method: str = "auto"               # direct-LU engine
    lu_order: str = "amd"                 # direct-LU fill-reducing ordering
    lu_pivot_tol: float = 0.1             # partial-pivoting threshold
    transpose: bool = False               # also build the exact M⁻ᵀ apply
    schwarz_overlap: int = 8              # RAS subdomain overlap (rows)
    arms_tol: float = 1e-3                # ARMS Schur drop tolerance
    arms_max_levels: int = 10
    arms_coarse_size: int = 200
    amg_max_levels: int = 12
    amg_coarse_size: int = 64
    amg_theta: float = 0.25               # strength-of-connection threshold
    amg_presmooth: int = 2
    amg_postsmooth: int = 2
    amg_smooth_interp: bool = True
    amg_trunc: float = 0.2
    amg_smoother: str = "chebyshev"
    amg_cycles: int = 1
    amg_cycle_type: str = "V"
    amg_force_classical: bool = False
    amg_max_pdiags: int = 40
    saamg_aggregate: int = 4
    saamg_grid: Any = None
    # user-PC hooks (the reference's LSSP_PC_USER, pc.cxx:219-227)
    user_setup: Optional[Callable] = None
    user_apply: Optional[Callable] = None

    def resolved(self) -> "PCOptions":
        d = Defaults
        return dataclasses.replace(
            self,
            iluk_level=int(_resolve(self.iluk_level, d.ILUK_LEVEL)),
            ilut_tol=_resolve(self.ilut_tol, d.ILUT_TOL),
            ilut_p=self.ilut_p if self.ilut_p is not None else d.ILUT_P,
        )


def smoother_degree(pre: int, post: int) -> int:
    """The reference's separate pre- and post-smoothing counts as the one
    symmetric degree of the multigrid cycles (which smooth the same number
    of times on both sides of the coarse correction): the total work kept,
    degree = ceil((pre + post) / 2); 0/0 disables smoothing."""
    pre, post = int(pre), int(post)
    if pre <= 0 and post <= 0:
        return 0
    return max(1, (pre + post + 1) // 2)
