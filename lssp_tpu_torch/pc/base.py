"""Preconditioner protocol and registry.

A ``Preconditioner`` is an apply function plus its device state; calling
``M(r)`` applies M⁻¹, the contract every Krylov solver uses (reference
LSSP_PC_SOLVE).  Every ported PC applies to r (n,) and to an (n, k) block
column by column (the multi-rhs path).  ``setup`` builds one from a host CSR matrix on a given
device (reference lssp_pc_assemble, pc.cxx:81-239).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from lssp_tpu_torch.config import Defaults, PCOptions, resolve_device
from lssp_tpu_torch.sparse.types import round_to
from lssp_tpu_torch.sparse.utils import diagonal


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """``M(r)`` applies M⁻¹; ``M.t(r)`` applies M⁻ᵀ where installed."""

    apply_fn: Callable      # (state, r) -> z
    state: Any
    name: str = "user"
    apply_t_fn: Any = None  # (state, r) -> M⁻ᵀr, or None

    def __call__(self, r):
        return self.apply_fn(self.state, r)

    def t(self, r):
        """Apply M⁻ᵀ.  Raises when the PC has none: substituting M⁻¹ would
        corrupt two-sided recurrences."""
        if self.apply_t_fn is None:
            raise ValueError(f"preconditioner {self.name!r} has no transpose apply")
        return self.apply_t_fn(self.state, r)


PC_REGISTRY = {}


def register_pc(name):
    def deco(fn):
        PC_REGISTRY[name] = fn
        return fn
    return deco


_VALUE_DTYPE: contextvars.ContextVar = contextvars.ContextVar("pc_value_dtype", default=None)


def value_dtype():
    """The torch dtype the preconditioner being set up rounds its values
    to, where that differs from its host matrix's (bfloat16), else None."""
    return _VALUE_DTYPE.get()


def round_factor(T):
    """A host factor rounded to ``value_dtype()`` (unchanged when None):
    the factors of a bfloat16 PC are computed in float64 and rounded once,
    as JAX's bf16 factors are (``lssp_tpu/pc/ilu_host.py: ilu0_numeric``)."""
    dt = value_dtype()
    return T if dt is None else round_to(T, dt)


def setup(A, pc_type: str = "none", opts: PCOptions = None, device=None,
          dtype=None) -> Preconditioner:
    """Assemble a preconditioner for the host CSR matrix ``A`` with its
    state on ``device`` (``config.resolve_device``: the current CUDA device
    unless one is named).  ``dtype`` (torch) builds it in that precision
    from A's values rounded to it (None: A's own dtype).  numpy has no
    bfloat16, so a bfloat16 PC is built on the host in float32 from A
    rounded to bf16 (``round_to``), its factors rounded to bf16 once
    (``round_factor``), and its state cast to bf16 on the device, except
    K2's Neumann plan, which stays float32 (K2 takes no bf16: the apply
    casts r in and z out, as JAX's fp32-only kernel does)."""
    opts = (opts or PCOptions()).resolved()
    key = (pc_type or "none").lower()
    if key not in PC_REGISTRY:
        raise ValueError(f"unknown preconditioner {pc_type!r}; "
                         f"available: {sorted(PC_REGISTRY)}")
    device = resolve_device(device)
    if dtype is None:
        return PC_REGISTRY[key](A, opts, device)
    A = round_to(A, dtype)
    if dtype != torch.bfloat16:
        return PC_REGISTRY[key](A, opts, device)
    with rounding_to(dtype):
        M = PC_REGISTRY[key](A, opts, device)
    return dataclasses.replace(M, state=cast_state(M.state, dtype))


@contextlib.contextmanager
def rounding_to(dtype):
    """Within the block, ``round_factor`` rounds to ``dtype`` when it is
    bfloat16 (no rounding otherwise): the setup of a bf16 PC."""
    token = _VALUE_DTYPE.set(dtype if dtype == torch.bfloat16 else None)
    try:
        yield
    finally:
        _VALUE_DTYPE.reset(token)


def cast_state(state, dtype):
    """A PC state with its floating tensors cast to ``dtype``; K2's
    ``FusedNeumann`` plans are kept as they are (float32)."""
    from lssp_tpu_torch.ops.neumann import FusedNeumann
    from lssp_tpu_torch.utils.tree import map_tensors

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t
    return map_tensors(cast, state, skip=(FusedNeumann,))


def _identity_apply(state, r):
    return r


@register_pc("none")
def _setup_none(A, opts, device):
    """solve = copy (reference pc.cxx:67-79)."""
    return Preconditioner(_identity_apply, state=(), name="none",
                          apply_t_fn=_identity_apply)


def _jacobi_apply(state, r):
    """D⁻¹r for r (n,) or an (n, k) block."""
    return (state[:, None] if r.ndim == 2 else state) * r


@register_pc("jacobi")
def _setup_jacobi(A, opts, device):
    """Diagonal scaling z = D⁻¹r; near-zero diagonals clamped like the
    reference's ILU pivot guard (pc-iluk.cxx:367-374)."""
    d = diagonal(A).copy()
    small = np.abs(d) < Defaults.ZERO_DIAG_TOL
    d[small] = np.where(d[small] > 0, Defaults.ZERO_DIAG_VALUE, -Defaults.ZERO_DIAG_VALUE)
    inv = torch.from_numpy((opts.omega / d).astype(A.data.dtype)).to(device)
    return Preconditioner(_jacobi_apply, state=inv, name="jacobi",
                          apply_t_fn=_jacobi_apply)


@register_pc("user")
def _setup_user(A, opts, device):
    """Caller-supplied hooks (reference LSSP_PC_USER, pc.cxx:219-227):
    ``PCOptions.user_setup(A)`` builds the state from the host matrix (none
    when unset) and ``user_apply(state, r)`` applies M⁻¹.  No M⁻ᵀ is
    installed: a transpose method needs an ``M`` with a ``.t``."""
    if opts.user_apply is None:
        raise ValueError("user PC requires PCOptions.user_apply")
    state = opts.user_setup(A) if opts.user_setup is not None else ()
    return Preconditioner(opts.user_apply, state=state, name="user")
