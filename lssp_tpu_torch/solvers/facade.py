"""Public solve API: the one-shot ``solve()`` and ``solve_multi()`` and the
``Solver`` lifecycle (the reference's create → assemble → solve protocol,
lssp.h:44-53).  Assembly reorders the matrix when asked, converts it to
its execution format on the device and builds the preconditioner once;
repeated solves reuse all three.

``solve_multi`` solves k right-hand sides at once, B (n, k) in the block
layout of ``ops/spmv.py``: a block method (``blockcg``, ``blockgmres``)
shares one search block across the columns; any other method runs its
per-column batched form, every column on its own single-rhs trajectory.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from lssp_tpu_torch import pc as pc_mod
from lssp_tpu_torch.config import PCOptions, SolverOptions, resolve_device
from lssp_tpu_torch.solvers.registry import get_batched_solver, get_block_solver, get_solver
from lssp_tpu_torch.sparse.convert import (
    bsr_to_bdia, bsr_to_csr, coo_to_csr, csr_entry_offsets, csr_to_dia, csr_to_ell,
    to_device_format,
)
from lssp_tpu_torch.sparse.reorder import maybe_rcm, permute_symmetric
from lssp_tpu_torch.sparse.types import BDIA, BSR, COO, CSR, DIA, ELL, HYB
from lssp_tpu_torch.sparse.utils import sort_columns
from lssp_tpu_torch.utils.log import Timer, set_log
from lssp_tpu_torch.utils.memo import fingerprint, memo_get, memo_put
from lssp_tpu_torch.utils.profile import add_bytes, tree_device_bytes


# the methods that apply M⁻ᵀ (and Aᵀ): every entry point builds their
# preconditioner with PCOptions(transpose=True)
TRANSPOSE_METHODS = frozenset(("bicg", "qmr", "cgnr", "cgn", "lsqr"))
# the methods that take a rectangular A (least squares)
_RECTANGULAR_OK = frozenset(("lsqr",))


def direct_pc(method: str, pc, M=None):
    """The PC a solve builds: ``"lu"`` for ``direct`` / ``splu`` when no PC
    and no M is given (a direct solve is one apply of the exact-LU PC, as
    in JAX's facade), else ``pc``."""
    if method.lower() in ("direct", "splu") and pc in (None, "none") and M is None:
        return "lu"
    return pc


def needs_transpose_pc(method: str) -> bool:
    """Whether ``method`` applies M⁻ᵀ: its PC is built with the transpose
    apply (``PCOptions(transpose=True)``), one list for every entry point."""
    return method.lower() in TRANSPOSE_METHODS


def transpose_options(method: str, pc_options):
    """``pc_options`` with ``transpose=True`` for a transpose method, else
    as given."""
    if not needs_transpose_pc(method):
        return pc_options
    return dataclasses.replace(pc_options or PCOptions(), transpose=True)


def validate_system(A, b, method: str):
    """The reference's assemble-time checks (square operator, matching rhs
    length; lssp.cxx:147-160); ``lsqr`` also takes a rectangular A.
    Returns b as a tensor, cast to float64 when it is not floating point."""
    shape = getattr(A, "shape", None)
    if shape is not None and len(shape) == 2 and shape[0] != shape[1] \
            and method.lower() not in _RECTANGULAR_OK:
        raise ValueError(f"method={method!r} needs a SQUARE matrix, got {shape}; use "
                         "method='lsqr' for least-squares systems")
    if b is None:
        return None
    b = torch.as_tensor(b)
    if b.ndim != 1:
        raise ValueError(f"rhs must be 1-D, got shape {tuple(b.shape)}")
    if shape is not None and b.shape[0] != shape[0]:
        raise ValueError(f"rhs length {b.shape[0]} does not match the matrix "
                         f"rows {shape[0]}")
    if not b.is_floating_point():
        b = b.to(torch.float64)
    return b


def validate_block(A, B, entry: str, method: str = ""):
    """``validate_system`` for a multi-rhs solve: B must be (n, k) with the
    matrix's row count (``lsqr`` takes a rectangular A); an integer B is
    cast to float64."""
    shape = getattr(A, "shape", None)
    if shape is not None and len(shape) == 2 and shape[0] != shape[1] \
            and method.lower() not in _RECTANGULAR_OK:
        raise ValueError(f"{entry} needs a SQUARE matrix, got {shape}")
    B = torch.as_tensor(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k) for {entry}, got shape {tuple(B.shape)}")
    if shape is not None and B.shape[0] != shape[0]:
        raise ValueError(f"rhs rows {B.shape[0]} do not match the matrix rows {shape[0]}")
    if not B.is_floating_point():
        B = B.to(torch.float64)
    return B


def reject_block_method(method: str, entry: str) -> None:
    """A single-rhs entry point refuses a block method, naming the multi
    entry point that takes it."""
    if get_block_solver(method) is not None:
        raise ValueError(f"{method!r} is a multi-rhs block method; use {entry} "
                         "for (n, k) right-hand sides")


def saamg_keeps_ordering(pc, pc_options) -> bool:
    """Whether explicit saamg grid dims (``saamg_grid`` = (gy, gx)) pin the
    user's row ordering: reordering would scramble the boxes.
    ``saamg_grid=None`` (detect) and ``False`` (flat) impose nothing."""
    if pc != "saamg" or pc_options is None:
        return False
    g = pc_options.saamg_grid
    # identity checks: grid dims may be a numpy array
    return g is not None and g is not False


def resolve_reorder(pc, pc_options, reorder):
    """The reorder rule of every entry point.  Explicit saamg grid dims pin
    the ordering; ``"auto"`` with ``saamg`` or ``rsamg`` becomes the
    hierarchical-aggregation ordering ``hier:g:coarse:levels``
    (``amg/aggregate.py``), so on a matrix with no detectable grid the flat
    reshape aggregates are strength aggregates at every level.  ``amg``
    keeps the ordering (the JAX package reorders it on the TPU only)."""
    if reorder != "auto" or not isinstance(pc, str):
        return reorder
    if saamg_keeps_ordering(pc, pc_options):
        return None
    if pc in ("saamg", "rsamg"):
        o = pc_options or PCOptions()
        return f"hier:{o.saamg_aggregate}:{o.amg_coarse_size}:{o.amg_max_levels}"
    return reorder


def _maybe_hierarchy(A: CSR, mode: str):
    """The hierarchical-aggregation ordering of a ``hier:g:coarse:levels``
    mode: (the permuted CSR, perm), or (None, None) when A has a detectable
    grid (direction-aware grid aggregation wins there) or the ordering is
    the identity."""
    from lssp_tpu_torch.amg.aggregate import hierarchy_perm
    from lssp_tpu_torch.amg.sa import detect_grid
    if detect_grid(A) is not None:
        return None, None
    g, coarse, levels = (int(v) for v in mode.split(":")[1:])
    p = hierarchy_perm(A, g=g, coarse_size=coarse, max_levels=levels)
    if np.array_equal(p, np.arange(A.shape[0])):
        return None, None
    return permute_symmetric(A, p), p


_EXEC_FORMATS = (DIA, HYB, ELL, BDIA)
_HIER = re.compile(r"hier:\d+:\d+:\d+$")


def _bsr_device_format(A: BSR, csr: CSR, device):
    """The execution format of a block matrix (``lssp_tpu/solvers/facade.py:
    220-248``): scalar DIA when it has at most 64 diagonals and
    len(offsets)·n ≤ 3·nnz (kernel K1), else BDIA (32 block diagonals,
    fill 2), else padded ELL of the scalar CSR."""
    try:
        _, _, offs = csr_entry_offsets(csr.indptr, csr.indices, csr.shape[0])
        if len(offs) <= 64 and len(offs) * csr.shape[0] <= 3.0 * max(csr.nnz, 1):
            return csr_to_dia(csr, max_diags=64, device=device)
    except ValueError:
        pass
    try:
        return bsr_to_bdia(A, max_diags=32, fill=2.0, device=device)
    except ValueError:
        return csr_to_ell(csr, device=device)


def _prepare_matrix(A, reorder="auto", device="cpu"):
    """Host CSR (or COO) → (reordered) execution format on ``device``,
    memoized on the container per (reorder, device) in
    ``A._prepared_cache`` (``utils.memo``: each entry checked against the
    container's content fingerprint).  Returns (host CSR or None, device
    format, perm or None, the fingerprint taken once for this call, None
    for a container without host buffers).  ``perm`` is an int64 tensor on ``device``: the system
    solved is P·A·Pᵀ with (P·v)[i] = v[perm[i]], and the host CSR is the
    permuted one.  Execution containers move to ``device``; callables pass
    through.

    ``reorder``: "rcm" runs ``maybe_rcm``; ``hier:g:coarse:levels`` the
    hierarchical-aggregation ordering (``_maybe_hierarchy``); "auto" and
    None keep the ordering (the JAX package reorders under "auto" only on
    the TPU; ``resolve_reorder`` maps "auto" to ``hier:`` for saamg and
    rsamg first).  A host ``BSR`` is never reordered (as in the JAX
    package): its host CSR is the scalar view (explicit zeros dropped) and
    its format ``_bsr_device_format``'s, one memo entry per device."""
    hier = isinstance(reorder, str) and bool(_HIER.match(reorder))
    if reorder not in ("auto", "rcm", None) and not hier:
        raise ValueError(f"unknown reorder {reorder!r}")
    reorder = reorder or "auto"         # one memo entry for the two spellings
    device = torch.device(device)
    if isinstance(A, _EXEC_FORMATS):
        return None, A.to(device), None, None
    if not isinstance(A, (CSR, COO, BSR)):
        return None, A, None, None
    fp = fingerprint(A)
    if isinstance(A, BSR):
        key = ("prepared", "bsr", str(device))
        out = memo_get(A, "_prepared_cache", key, fp)
        if out is None:
            csr = bsr_to_csr(A)
            out = (csr, _bsr_device_format(A, csr, device), None)
            add_bytes("upload", tree_device_bytes(out[1]))
            memo_put(A, "_prepared_cache", key, fp, out)
        return out + (fp,)
    key = ("prepared", reorder, str(device))
    out = memo_get(A, "_prepared_cache", key, fp)
    if out is None:
        host = sort_columns(coo_to_csr(A) if isinstance(A, COO) else A)
        perm = None
        permuted, p = None, None
        square = host.shape[0] == host.shape[1]     # a rectangular A (lsqr) keeps its order
        if square and reorder == "rcm":
            permuted, p = maybe_rcm(host)
        elif square and hier:
            permuted, p = _maybe_hierarchy(host, reorder)
        if p is not None:
            host, perm = permuted, torch.from_numpy(p).to(device)
        out = (host, to_device_format(host, device=device), perm)
        add_bytes("upload", tree_device_bytes(out[1]))
        memo_put(A, "_prepared_cache", key, fp, out)
    return out + (fp,)


def _permute(v, perm):
    """P·v (v[perm]); v itself without a permutation."""
    return v if perm is None else v[perm]


def _unpermute(x, perm):
    """Pᵀ·x: the solution of the permuted system back in the user's order
    (the rows of a block)."""
    if perm is None:
        return x
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _system_dtype(A_dev, b):
    """The dtype a solve runs in: b's, promoted with the matrix's."""
    if isinstance(A_dev, _EXEC_FORMATS):
        return torch.promote_types(A_dev.dtype, b.dtype)
    return b.dtype


def _setup_pc(A_host, pc, pc_options, dtype, device):
    """The preconditioner, built from the host matrix in the solve dtype."""
    if A_host is None:
        raise ValueError("preconditioner setup needs a host CSR matrix; "
                         "pass M= explicitly for operator inputs")
    return pc_mod.setup(A_host, pc, pc_options, device=device, dtype=dtype)


def _as_system(A_dev, b, x0, dtype, device):
    """The matrix, b and x0 on ``device`` in ``dtype``; a block b and x0
    are made contiguous here, at the API boundary, as the k-rhs kernels
    take no other layout.  x0 lives in the column space: ``A.shape[1]``
    rows, which differs from b's for a rectangular A (lsqr)."""
    if isinstance(A_dev, _EXEC_FORMATS) and A_dev.dtype != dtype:
        A_dev = A_dev.to(dtype=dtype)
    b = b.to(device=device, dtype=dtype).contiguous()
    shape = getattr(A_dev, "shape", None)
    xshape = ((shape[1] if shape is not None else b.shape[0]),) + tuple(b.shape[1:])
    x0 = (b.new_zeros(xshape) if x0 is None
          else torch.as_tensor(x0).to(device=device, dtype=dtype).contiguous())
    if tuple(x0.shape) != xshape:
        raise ValueError(f"x0 must have shape {xshape} (the matrix's columns), got "
                         f"{tuple(x0.shape)}")
    return A_dev, b, x0


def solve(A, b, x0=None, method: str = "gmres", pc: Optional[str] = "none",
          options: Optional[SolverOptions] = None,
          pc_options: Optional[PCOptions] = None, M=None, reorder: str = "auto",
          device=None):
    """Solve A x = b.  Returns ``(x, SolveInfo)``.

    ``A``: host CSR/COO (converted to DIA/HYB/ELL on ``device``), a host
    BSR (scalar DIA, BDIA or ELL: ``_bsr_device_format``), an execution
    container, or a callable ``x ↦ A@x``.  ``pc``: a registry
    name, or ``M`` a prebuilt Preconditioner or callable.  ``reorder``:
    "rcm" solves the RCM-permuted system when ``maybe_rcm`` takes a
    permutation (x comes back in the original order); "auto" keeps the
    ordering, except that saamg and rsamg take the hierarchical-aggregation
    ordering (``resolve_reorder``); None keeps it always.  ``device``:
    where the solve runs; None means b's device for a tensor b and the
    current CUDA device otherwise (no CUDA device raises: pass
    ``device="cpu"``).  The solve runs in b's dtype promoted with the
    matrix's."""
    opts = (options or SolverOptions()).resolved()
    device = resolve_device(device, b)
    b = validate_system(A, b, method)
    reject_block_method(method, "solve_multi")
    pc = direct_pc(method, pc, M)
    reorder = resolve_reorder(pc, pc_options, reorder)
    A_host, A_dev, perm, _ = _prepare_matrix(A, reorder=reorder, device=device)
    dtype = _system_dtype(A_dev, b)
    if M is None and pc not in (None, "none"):
        M = _setup_pc(A_host, pc, transpose_options(method, pc_options), dtype, device)
    A_dev, b, x0 = _as_system(A_dev, b, x0, dtype, device)
    x, info = get_solver(method)(A_dev, _permute(b, perm), _permute(x0, perm), M, opts=opts)
    return _unpermute(x, perm), info


def solve_multi(A, B, X0=None, method: str = "cg", pc: Optional[str] = "none",
                options: Optional[SolverOptions] = None,
                pc_options: Optional[PCOptions] = None, M=None, reorder: str = "auto",
                device=None):
    """Solve A·X = B for k right-hand sides at once (B: (n, k), the columns
    are the rhs).  Returns (X (n, k), SolveInfo whose fields are (k,)
    arrays: per-column counts, residuals and convergence flags).

    ``method``: "blockcg" / "blockgmres" share one search block; any other
    method runs column by column in one batched loop, each column on its
    own single-rhs trajectory and count (JAX's ``jax.vmap``).  Either way
    the matrix and preconditioner stream once per iteration for all k
    columns (kernels K1k-K3k on CUDA).  Other arguments as in ``solve``;
    ``reorder="rcm"`` permutes B's rows."""
    opts = (options or SolverOptions()).resolved()
    device = resolve_device(device, B)
    B = validate_block(A, B, "solve_multi", method)
    pc = direct_pc(method, pc, M)
    reorder = resolve_reorder(pc, pc_options, reorder)
    A_host, A_dev, perm, _ = _prepare_matrix(A, reorder=reorder, device=device)
    dtype = _system_dtype(A_dev, B)
    if M is None and pc not in (None, "none"):
        M = _setup_pc(A_host, pc, transpose_options(method, pc_options), dtype, device)
    A_dev, B, X0 = _as_system(A_dev, B, X0, dtype, device)
    return _run_multi(method, A_dev, M, B, X0, perm, opts)


def _run_multi(method, A_dev, M, B, X0, perm, opts):
    """The multi-rhs solve on prepared device state (shared by
    ``solve_multi`` and ``Solver.solve_multi``): the block solver, or the
    method's per-column batched form, on the permuted block."""
    fn = get_block_solver(method) or get_batched_solver(method)
    X, info = fn(A_dev, _permute(B, perm), _permute(X0, perm), M, opts=opts)
    return _unpermute(X, perm), info


class Solver:
    """Lifecycle API with the reference's setters (lssp.cxx:416-535).
    ``solve`` takes one rhs, ``solve_multi`` a block on the same assembled
    state; ``residual`` and ``nits`` are scalars after the one and (k,)
    arrays after the other.  ``device``: as in ``solve``, resolved at
    ``assemble`` (a tensor b there gives its device)."""

    def __init__(self, method: str = "gmres", pc: Optional[str] = "none",
                 options: Optional[SolverOptions] = None,
                 pc_options: Optional[PCOptions] = None, device=None):
        self.method = method
        self.pc_type = pc
        self.options = options or SolverOptions()
        self.pc_options = pc_options or PCOptions()
        self.device_request = device
        self.device = None
        self.A_host = None
        self.A_dev = None
        self.perm = None
        self.M = None
        self.b = None
        self.x = None
        self.info = None
        self.dtype = None
        self.assembled = False

    def _set(self, **kw):
        self.options = dataclasses.replace(self.options, **kw)
        return self

    # -- setters (lssp_solver_set_*, reference lssp.h:65-89) --
    def set_rtol(self, v):    return self._set(rtol=v)
    def set_atol(self, v):    return self._set(atol=v)
    def set_rbtol(self, v):   return self._set(rbtol=v)
    def set_maxit(self, v):   return self._set(maxit=v)
    def set_restart(self, v): return self._set(restart=v)
    def set_augk(self, v):    return self._set(aug_k=v)
    def set_bgsl(self, v):    return self._set(bgsl=v)
    def set_idrs(self, v):    return self._set(idrs=v)

    def set_log(self, f):
        """Tee this solver's output to the file object ``f`` (reference
        lssp_solver_set_log, lssp.cxx:530-535; the log is process-global
        underneath, as in the reference and JAX: ``utils.log.set_log``)."""
        set_log(f)
        return self

    def reset_type(self, method: str):
        """Switch the Krylov method, keeping the assembled matrix (reference
        lssp_solver_reset_type, lssp.cxx:426-433).  Switching to a transpose
        method rebuilds the PC with its M⁻ᵀ apply, unless it was built with
        ``PCOptions(transpose=True)``."""
        self.method = method
        if (self.assembled and self.M is not None and self.pc_type not in (None, "none")
                and needs_transpose_pc(method)
                and not (self.pc_options and self.pc_options.transpose)):
            self.M = _setup_pc(self.A_host, self.pc_type,
                               transpose_options(method, self.pc_options), self.dtype,
                               self.device)
        return self

    def assemble(self, A, b=None, x0=None, reorder: str = "auto"):
        """Reorder (``reorder="rcm"``) and convert the matrix and build the PC
        (reference lssp_solver_assemble → lssp_pc_assemble), logging the two
        phase times as the reference does (matrix at verbosity 2, PC at 1).
        ``b`` and ``x0`` stay in the user's order; each solve permutes them
        in."""
        self.device = resolve_device(self.device_request, b)
        b = validate_system(A, b, self.method)
        self.pc_type = direct_pc(self.method, self.pc_type)
        reorder = resolve_reorder(self.pc_type, self.pc_options, reorder)
        with Timer("solver: assemble (matrix conversion)", level=2):
            self.A_host, self.A_dev, self.perm, _ = _prepare_matrix(A, reorder=reorder,
                                                                    device=self.device)
        # the system dtype is fixed here: the matrix's, promoted with b's
        self.dtype = (_system_dtype(self.A_dev, b) if b is not None
                      else getattr(self.A_dev, "dtype", torch.float64))
        if self.pc_type not in (None, "none"):
            with Timer(f"pc: assemble ({self.pc_type})", level=1):
                self.M = _setup_pc(self.A_host, self.pc_type,
                                   transpose_options(self.method, self.pc_options),
                                   self.dtype, self.device)
        if b is not None:
            self.b = b
        if x0 is not None:
            self.x = torch.as_tensor(x0)
        self.assembled = True
        return self

    def reset_rhs(self, b):
        """New rhs, keep the factorization (reference lssp_solver_reset_rhs)."""
        self.b = validate_system(self.A_dev, b, self.method)
        return self

    def reset_unknown(self, x0):
        """New initial guess (reference lssp_solver_reset_unknown)."""
        self.x = torch.as_tensor(x0)
        return self

    def solve(self, b=None, x0=None):
        if not self.assembled:
            raise RuntimeError("call assemble() first")
        reject_block_method(self.method, "Solver.solve_multi")
        if b is not None:
            self.reset_rhs(b)
        if x0 is not None:
            self.reset_unknown(x0)
        if self.b is None:
            raise ValueError("no right-hand side: pass b to assemble(), "
                             "reset_rhs() or solve()")
        # a prior solve_multi leaves an (n, k) solution in self.x: never a
        # scalar warm start, only a rank-1 previous x is
        x0 = self.x if self.x is not None and self.x.ndim == 1 else None
        A_dev, b, x0 = _as_system(self.A_dev, self.b, x0, self.dtype, self.device)
        x, info = get_solver(self.method)(A_dev, _permute(b, self.perm),
                                          _permute(x0, self.perm), self.M,
                                          opts=self.options.resolved())
        self.x, self.info = _unpermute(x, self.perm), info
        return self.x

    def solve_multi(self, B, X0=None):
        """Solve A·X = B for k right-hand sides (B: (n, k)) on the assembled
        matrix and preconditioner, as ``solve_multi`` does; keeps X and the
        per-column SolveInfo and returns X."""
        if not self.assembled:
            raise RuntimeError("call assemble() first")
        B = validate_block(self.A_dev, B, "Solver.solve_multi", self.method)
        A_dev, B, X0 = _as_system(self.A_dev, B, X0, self.dtype, self.device)
        self.x, self.info = _run_multi(self.method, A_dev, self.M, B, X0, self.perm,
                                       self.options.resolved())
        return self.x

    # -- getters (lssp_solver_get_residual/_nits, reference lssp.cxx:520-528);
    # scalars after solve(), (k,) arrays after solve_multi() --
    @property
    def residual(self):
        if self.info is None:
            return None
        r = np.asarray(self.info.residual)
        return float(r) if r.ndim == 0 else r

    @property
    def nits(self):
        if self.info is None:
            return None
        n = np.asarray(self.info.nits)
        return int(n) if n.ndim == 0 else n
