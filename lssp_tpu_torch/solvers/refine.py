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
    _prepare_matrix, _setup_choices, _unpermute, check_input, needs_transpose_pc,
    place_system, solver_for, transpose_options,
)
from lssp_tpu_torch.utils import profile as _prof
from lssp_tpu_torch.utils.log import log
from lssp_tpu_torch.utils.memo import _pc_options_key, memo_get, memo_put


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
    # IR around a direct solve: an fp32 LU inner
    device = resolve_device(device)
    pc, reorder = _setup_choices(method, pc, pc_options, reorder)
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
    return solver_for(inner, multi), inner_opts


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


def refine(op64, inner, b, x, opts, max_outer, inner_dtype, norm, bnorm=None, verbosity=0):
    """The single-rhs refinement rounds, shared with the distributed
    launcher: the fp64 residual through ``op64``, the scaled inner solve
    ``inner(r32) -> (d32, info)`` in ``inner_dtype``, fp64 accumulation,
    until the true residual meets max(rtol·‖b‖, atol) or ``max_outer``
    rounds.  ``norm``: ‖v‖ as a 0-d tensor (the mesh's reduces over the
    shards).  ``bnorm``: ‖b‖ when the caller has it, so that a repeated
    solve takes no norm of b of its own.  ``verbosity`` ≥ 1 logs each round.
    Returns (x, SolveInfo; nits the total inner iterations)."""
    if bnorm is None:
        bnorm = norm(b).item()
    tol = max(opts.rtol * bnorm, opts.atol)
    r = b - op64(x)
    res = r0 = norm(r).item()
    total = outer = 0
    while res > tol and outer < max_outer:
        with _prof.annotate("lssp.ir.round"):
            scale = res if res != 0.0 else 1.0
            r32 = (r / scale).to(inner_dtype)
            with _prof.annotate("lssp.krylov.inner"):
                d32, info = inner(r32)
            x = x + d32.to(torch.float64) * scale
            r = b - op64(x)
            res = norm(r).item()
        total += info.nits
        outer += 1
        if verbosity >= 1:
            log(f"ir outer: {outer:3d}, inner its: {info.nits:4d}, true res: "
                f"{res:.6e}, rel res: {res / max(r0, np.finfo(np.float64).tiny):.6e}",
                level=0)
    return x, SolveInfo(nits=total, residual=res, converged=res <= tol, r0norm=r0,
                        bnorm=bnorm, history=None)


def _request_ir(A, b, x0, method, pc, pc_options, opts, inner_rtol, inner_dtype, reorder,
                device, block):
    """check → prepare of every one-card refinement entry point: the input
    (``check_input``), ``prepare_ir``'s memoized state, b and x0 placed in
    fp64 (``place_system``) and the inner plan (``_inner_plan``).  Returns
    (op64, inner, P·b, P·x0, perm): the arguments of ``refine`` and
    ``refine_multi``."""
    device = resolve_device(device, b)
    b = check_input(A, b, method, "solve_ir_multi", block)
    _, A64, A32, perm, M32 = prepare_ir(A, method=method, pc=pc, pc_options=pc_options,
                                        inner_dtype=inner_dtype, reorder=reorder,
                                        device=device)
    b, x = place_system(A64.shape, b, x0, torch.float64, device, perm)
    fn, inner_opts = _inner_plan(method, opts, inner_rtol, multi=block)

    def inner(r32):
        z = r32.new_zeros((A32.shape[1],) + tuple(r32.shape[1:]))
        return fn(A32, r32, z, M32, opts=inner_opts)
    return (lambda v: spmv(A64, v)), inner, b, x, perm


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
        opts = (options or SolverOptions()).resolved()
        op64, inner, b, x, perm = _request_ir(A, b, x0, method, pc, pc_options, opts,
                                              inner_rtol, inner_dtype, reorder, device,
                                              block=False)
        x, info = refine(op64, inner, b, x, opts, max_outer, inner_dtype, norm,
                         verbosity=opts.verbosity)
        return _unpermute(x, perm), info


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
    op64, inner, b, x0, _ = _request_ir(A, b, None, method, pc, pc_options, opts, inner_rtol,
                                        inner_dtype, reorder, device, block=False)
    bnorm = norm(b).item()

    def batch(r):
        t0 = time.perf_counter()
        for _ in range(r):
            x, info = refine(op64, inner, b, x0, opts, max_outer, inner_dtype, norm,
                             bnorm=bnorm)
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
        op64, inner, B, X, perm = _request_ir(A, B, X0, method, pc, pc_options, opts,
                                              inner_rtol, inner_dtype, reorder, device,
                                              block=True)
        X, info = refine_multi(op64, inner, B, X, opts, max_outer, inner_dtype, norm)
        return _unpermute(X, perm), info
