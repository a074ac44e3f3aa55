"""Mixed-precision iterative refinement (Krylov-IR):

    repeat:  r = b − A·x          (fp64 SpMV)
             d ≈ A⁻¹ r            (fp32 Krylov solve, fp32 preconditioner)
             x = x + d            (fp64 accumulation)

The inner solve only needs a few digits (inner_rtol 1e-3 by default), so
the hot loop runs in fp32 and the fp64 outer loop recovers the rest.  The
same policy as ``lssp_tpu/solvers/refine.py``; its fused device program
(``_fused_ir``) is a Python loop here.  ``solve_ir_multi`` runs the same
rounds on an (n, k) block (JAX's ``_fused_ir_multi``): one inner solve per
round for the whole block, a block method by default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lssp_tpu_torch import pc as pc_mod
from lssp_tpu_torch.config import PCOptions, SolverOptions, resolve_device
from lssp_tpu_torch.ops.spmv import spmv
from lssp_tpu_torch.solvers.base import norm, SolveInfo, to_host
from lssp_tpu_torch.solvers.facade import (
    _permute, _prepare_matrix, _unpermute, direct_pc, needs_transpose_pc, reject_block_method,
    resolve_reorder, transpose_options, validate_block, validate_system,
)
from lssp_tpu_torch.solvers.registry import get_batched_solver, get_block_solver, get_solver
from lssp_tpu_torch.utils import profile as _prof
from lssp_tpu_torch.utils.log import log
from lssp_tpu_torch.utils.memo import checksum, memo_get, memo_put


def _pc_options_key(pc_options):
    """Cache key for a PCOptions: array-valued fields hash their full
    bytes (a repr would summarize large arrays)."""
    if pc_options is None:
        return None
    parts = []
    for f in dataclasses.fields(pc_options):
        v = getattr(pc_options, f.name)
        if (hasattr(v, "__array__") or isinstance(v, (list, tuple))) \
                and not isinstance(v, str):
            a = np.asarray(v)
            parts.append((f.name, a.shape, str(a.dtype), checksum(a)))
        else:
            parts.append((f.name, repr(v)))
    return tuple(parts)


def prepare_ir(A, method: str = "gmres", pc: Optional[str] = "none",
               pc_options: Optional[PCOptions] = None, inner_dtype=torch.float32,
               reorder: str = "auto", device=None):
    """Setup phase of ``solve_ir`` alone: reorder (``resolve_reorder``),
    convert and upload the matrix in both precisions and build the
    inner-precision preconditioner from the (reordered) host matrix,
    memoized on the container so a following ``solve_ir`` finds everything
    cached.  Returns (A_host, A64, A32, perm, M32); ``perm`` as in
    ``facade._prepare_matrix``.  A transpose method (``needs_transpose_pc``)
    gets its PC with the M⁻ᵀ apply, under a memo key of its own: a
    forward-only PC cached by an earlier solve is never handed to it.
    ``device``: None is the current CUDA device (no CUDA device raises:
    pass ``device="cpu"``)."""
    device = resolve_device(device)
    pc = direct_pc(method, pc)          # IR around a direct solve: an fp32 LU inner
    reorder = resolve_reorder(pc, pc_options, reorder)
    with _prof.phase("reorder_convert"):
        A_host, A_dev, perm, fp = _prepare_matrix(A, reorder=reorder, device=device)
    if A_host is None:
        raise ValueError("solve_ir needs a host CSR or COO matrix")
    mat_key = ("ir-mat", reorder or "auto", str(inner_dtype), str(device))
    mats = memo_get(A, "_prepared_cache", mat_key, fp)
    if mats is None:
        with _prof.phase("upload"):
            mats = (A_dev.to(dtype=torch.float64), A_dev.to(dtype=inner_dtype))
        memo_put(A, "_prepared_cache", mat_key, fp, mats)
    A64, A32 = mats
    transpose = needs_transpose_pc(method)
    pc_key = ("ir-pc", mat_key, pc, transpose, _pc_options_key(pc_options))
    M32 = memo_get(A, "_prepared_cache", pc_key, fp)
    if M32 is None and pc not in (None, "none"):
        with _prof.phase("pc_build"):
            M32 = pc_mod.setup(A_host, pc, transpose_options(method, pc_options),
                               device=device, dtype=inner_dtype)
            _prof.add_bytes("pc_build", _prof.tree_device_bytes(M32.state))
        memo_put(A, "_prepared_cache", pc_key, fp, M32)
    return A_host, A64, A32, perm, M32


NORMAL_EQUATION_METHODS = ("cgnr", "cgn", "lsqr")


def _inner_plan(method, opts, inner_rtol, multi=False):
    """The fp32-inner policy: the inner solver and its options.

    The inner cap bounds a round that stalls on the fp32 floor just above
    inner_rtol (the outer loop collects the progress either way): 2 restart
    cycles for GMRES and block GMRES, 200 iterations otherwise, as in JAX.
    The normal-equation methods (cgnr, cgn, lsqr) take the whole ``maxit``
    instead: they converge slowly on the squared condition number rather
    than stall, and a capped round throws their Krylov space away (JAX's
    200 leaves 128³ + ILU(0) at relres 1.6e-2 after 20 rounds, 4,000 inner
    iterations; ``scripts/jax_krylov_reference.py 28``).  Inner
    GMRES is the right-preconditioned variant, whose Givens estimate does
    not stall on the fp32 floor the left variant hits with strong
    preconditioners; lgmres runs as rlgmres for the same reason, and
    fgmres as rgmres (the same method for solve_ir's fixed
    preconditioner).  Block GMRES runs inner cycles of min(restart, 16)
    steps: the ~1e-3 inner target needs far fewer steps than an outer
    restart.  ``multi``: a block method gives its block solver, any other
    method its per-column batched form."""
    key = method.lower()
    gmres_like = key in ("gmres", "rgmres", "lgmres", "rlgmres", "fgmres", "cagmres",
                         "cargmres", "blockgmres", "block_gmres")
    inner_cap = (max(2 * opts.restart, 64) if gmres_like
                 else opts.maxit if key in NORMAL_EQUATION_METHODS else 200)
    inner_opts = dataclasses.replace(opts, rtol=inner_rtol, atol=0.0, rbtol=0.0,
                                     maxit=min(opts.maxit, inner_cap))
    if key in ("blockgmres", "block_gmres"):
        inner_opts = dataclasses.replace(inner_opts, restart=min(opts.restart, 16))
    inner = {"gmres": "rgmres", "lgmres": "rlgmres", "fgmres": "rgmres",
             "cagmres": "cargmres"}.get(key, key)
    if multi:
        return get_block_solver(inner) or get_batched_solver(inner), inner_opts
    return get_solver(inner), inner_opts


def refine_multi(op64, inner, B, X, opts, max_outer, inner_dtype, norms):
    """The multi-rhs refinement rounds (JAX's ``_fused_ir_multi``), shared
    with the distributed launcher: per-column fp64 residuals through
    ``op64``, one inner solve ``inner(R32) -> (D32, info)`` per round for
    the whole block, fp64 accumulation.  A converged column is frozen: its
    inner rhs is zero, so the inner solver finishes it at 0 iterations and
    leaves it unchanged while the slowest column finishes.  ``norms``:
    the (k,) column norms.  Returns (X, SolveInfo with (k,) fields; nits
    counts each column's inner iterations)."""
    (bnorm,) = to_host(norms(B))
    tol = np.maximum(opts.rtol * bnorm, opts.atol)
    R = B - op64(X)
    (res,) = to_host(norms(R))
    r0 = res
    total = np.zeros(B.shape[1], np.int64)
    outer = 0
    while (res > tol).any() and outer < max_outer:
        with _prof.annotate("lssp.ir.round"):
            active = res > tol
            scale = torch.from_numpy(np.where(res == 0.0, 1.0, res)).to(B.device)
            R32 = torch.where(torch.from_numpy(active).to(B.device), R / scale, 0.0)
            with _prof.annotate("lssp.krylov.inner"):
                D32, info = inner(R32.to(inner_dtype))
            X = X + D32.to(torch.float64) * scale
            R = B - op64(X)
            (res,) = to_host(norms(R))
        total += np.asarray(info.nits)
        outer += 1
    if opts.verbosity >= 1:
        for j in range(B.shape[1]):
            log(f"ir rhs {j}: inner its {int(total[j]):4d}, true res {float(res[j]):.6e}",
                level=0)
    return X, SolveInfo(nits=total, residual=res, converged=res <= tol, r0norm=r0,
                        bnorm=bnorm, history=None)


def solve_ir(A, b, x0=None, method: str = "gmres", pc: Optional[str] = "none",
             options: Optional[SolverOptions] = None,
             pc_options: Optional[PCOptions] = None, inner_rtol: float = 1e-3,
             max_outer: int = 20, inner_dtype=torch.float32, reorder: str = "auto",
             device=None):
    """Solve to fp64 accuracy with inner solves in ``inner_dtype``.

    ``A``: host CSR/COO.  ``reorder`` and ``device``: as in ``solve``.
    Returns (x fp64, SolveInfo) where nits counts the total inner
    iterations and the residual is the true fp64 residual.  The call is
    the span ``lssp.solve_ir``."""
    with _prof.annotate("lssp.solve_ir"):
        reject_block_method(method, "solve_ir_multi")
        opts = (options or SolverOptions()).resolved()
        device = resolve_device(device, b)
        b = validate_system(A, b, method)
        _, A64, A32, perm, M32 = prepare_ir(A, method=method, pc=pc, pc_options=pc_options,
                                            inner_dtype=inner_dtype, reorder=reorder,
                                            device=device)
        b = _permute(b.to(device=device, dtype=torch.float64), perm)
        x = (b.new_zeros(A64.shape[1]) if x0 is None     # the column space (lsqr)
             else _permute(torch.as_tensor(x0).to(device=device, dtype=torch.float64), perm))
        bnorm = norm(b).item()
        tol = max(opts.rtol * bnorm, opts.atol)
        fn, inner_opts = _inner_plan(method, opts, inner_rtol)

        x, info = _refine(A64, A32, M32, b, x, tol, fn, inner_opts, max_outer, inner_dtype,
                          opts.verbosity)
        return _unpermute(x, perm), dataclasses.replace(info, bnorm=bnorm)


def _refine(A64, A32, M32, b, x, tol, fn, inner_opts, max_outer, inner_dtype, verbosity=0):
    """The refinement rounds of ``solve_ir`` on prepared state: fp64
    residual, the scaled inner solve in ``inner_dtype``, fp64 update, until
    the true residual meets ``tol`` or ``max_outer`` rounds.  Returns (x,
    SolveInfo; nits the total inner iterations, bnorm left None)."""
    r = b - spmv(A64, x)
    res = r0 = norm(r).item()
    total_inner = outer = 0
    while res > tol and outer < max_outer:
        with _prof.annotate("lssp.ir.round"):
            scale = res if res != 0.0 else 1.0
            r32 = (r / scale).to(inner_dtype)
            with _prof.annotate("lssp.krylov.inner"):
                d32, info = fn(A32, r32, r32.new_zeros(A32.shape[1]), M32, opts=inner_opts)
            x = x + d32.to(torch.float64) * scale
            r = b - spmv(A64, x)
            res = norm(r).item()
        total_inner += info.nits
        outer += 1
        if verbosity >= 1:
            log(f"ir outer: {outer:3d}, inner its: {info.nits:4d}, true res: "
                f"{res:.6e}, rel res: {res / max(r0, np.finfo(np.float64).tiny):.6e}",
                level=0)
    return x, SolveInfo(nits=total_inner, residual=res, converged=res <= tol, r0norm=r0,
                        bnorm=None, history=None)


def ir_device_time(A, b, method: str = "gmres", pc: Optional[str] = "none",
                   options: Optional[SolverOptions] = None,
                   pc_options: Optional[PCOptions] = None, inner_rtol: float = 1e-3,
                   max_outer: int = 20, inner_dtype=torch.float32, reorder: str = "auto",
                   repeats=(1, 4), reps: int = 3, device=None):
    """Time of one whole ``solve_ir`` solve on prepared state, by JAX's
    repeat-marginal (``lssp_tpu/solvers/refine.py: ir_device_time``): run
    the solve back to back ``repeats[0]`` and ``repeats[1]`` times, each
    batch from x = 0 and ending in ``torch.cuda.synchronize()`` on the
    card, take the fastest of ``reps`` batches of each, and difference, so
    the fixed costs of a batch cancel.  Setup (``prepare_ir``) is done
    once, first.  Returns (seconds_per_solve, nits, residual) of the
    solve."""
    import time
    opts = (options or SolverOptions()).resolved()
    device = resolve_device(device, b)
    b = validate_system(A, b, method)
    _, A64, A32, perm, M32 = prepare_ir(A, method=method, pc=pc, pc_options=pc_options,
                                        inner_dtype=inner_dtype, reorder=reorder,
                                        device=device)
    b = _permute(b.to(device=device, dtype=torch.float64), perm)
    tol = max(opts.rtol * norm(b).item(), opts.atol)
    fn, inner_opts = _inner_plan(method, opts, inner_rtol)

    def batch(r):
        t0 = time.perf_counter()
        for _ in range(r):
            x, info = _refine(A64, A32, M32, b, b.new_zeros(A64.shape[1]), tol, fn,
                              inner_opts, max_outer, inner_dtype)
        if b.device.type == "cuda":
            torch.cuda.synchronize(b.device)
        return time.perf_counter() - t0, info

    r1, r2 = repeats
    batch(r1)                                   # warm: kernels built and loaded
    t1s, t2s = [], []
    for _ in range(reps):
        t, info = batch(r1)
        t1s.append(t)
        t2s.append(batch(r2)[0])
    dt = (min(t2s) - min(t1s)) / (r2 - r1)
    return max(dt, 0.0), info.nits, info.residual


def solve_ir_multi(A, B, X0=None, method: str = "blockgmres", pc: Optional[str] = "none",
                   options: Optional[SolverOptions] = None,
                   pc_options: Optional[PCOptions] = None, inner_rtol: float = 1e-3,
                   max_outer: int = 20, inner_dtype=torch.float32, reorder: str = "auto",
                   device=None):
    """Mixed-precision refinement for k right-hand sides at once: fp64
    residuals per column, one ``inner_dtype`` inner solve per round for the
    whole block, fp64 accumulation.  ``B``: (n, k).  Returns (X fp64
    (n, k), SolveInfo with (k,) fields: nits counts each column's inner
    iterations, the residual is the true fp64 one).

    The default inner is ``blockgmres`` (``blockcg`` for SPD matrices): the
    k corrections share one block-Krylov basis.  Any other method runs its
    per-column batched form.  The serving path for many-rhs fp64
    workloads: the matrix streams once per iteration for all k columns
    (kernels K1k-K3k on CUDA).  Other arguments as in ``solve_ir``.  The
    call is the span ``lssp.solve_ir_multi``."""
    with _prof.annotate("lssp.solve_ir_multi"):
        opts = (options or SolverOptions()).resolved()
        device = resolve_device(device, B)
        B = validate_block(A, B, "solve_ir_multi", method)
        fn, inner_opts = _inner_plan(method, opts, inner_rtol, multi=True)
        _, A64, A32, perm, M32 = prepare_ir(A, method=method, pc=pc, pc_options=pc_options,
                                            inner_dtype=inner_dtype, reorder=reorder,
                                            device=device)
        B = _permute(B.to(device=device, dtype=torch.float64), perm).contiguous()
        X = (B.new_zeros(A64.shape[1], B.shape[1]) if X0 is None
             else _permute(torch.as_tensor(X0).to(device=device, dtype=torch.float64),
                           perm).contiguous())
        if X.shape != (A64.shape[1], B.shape[1]):
            raise ValueError(f"X0 must have shape {(A64.shape[1], B.shape[1])}, got "
                             f"{tuple(X.shape)}")

        def inner(R32):
            return fn(A32, R32, R32.new_zeros(A32.shape[1], R32.shape[1]), M32,
                      opts=inner_opts)

        X, info = refine_multi(lambda V: spmv(A64, V), inner, B, X, opts, max_outer,
                               inner_dtype, norm)
        return _unpermute(X, perm), info
