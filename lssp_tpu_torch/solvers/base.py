"""Shared solver skeleton.

The reference's pattern (reference solver-cg.cxx): resolve options →
r0 = b − A·x0 → threshold ``max(rtol·‖r0‖, atol, rbtol·‖b‖)`` (:66-70) →
iterate → report residual and iteration count.  The iteration is a Python
``while`` loop; each solver reads its convergence scalar to the host once
per iteration (one device sync), and scalars that only feed device math
stay 0-d tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from lssp_tpu_torch.ops.spmv import spmv, spmv_t
from lssp_tpu_torch.utils.log import log


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    """Result metadata (reference solver.residual / solver.nits).  After a
    multi-rhs solve (``solve_multi``, ``solve_ir_multi``, the block
    solvers) every field is a (k,) numpy array, one entry per column, and
    ``history`` is (k, maxit+1), as JAX's vmapped SolveInfo."""

    nits: Any               # iteration count (int, or (k,) int array)
    residual: Any           # final residual norm ‖b−Ax‖ (or the method's estimate)
    converged: Any
    r0norm: Any             # initial residual norm
    bnorm: Any              # ‖b‖
    history: Any = None     # optional (maxit+1,) residual trace, NaN-padded


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The port's one inner product: Σ_i a[i]·b[i] over dim 0, a 0-d tensor
    for (n,) vectors and a (k,) one for (n, k) blocks, one sum per column
    (broadcast trailing dims give one sum each).  Every dot and norm of the
    solvers and the AMG solve comes here, and on the CPU each shard's
    partial of the distributed one (``parallel/dist_ops.make_psum_dot``;
    on the card those partials are one reduction of their own).

    On CUDA each column is ``torch.dot`` of the (strided) column: cuBLAS
    sums a strided fp64 column as the contiguous vector, so a batched lane
    sums in its single-rhs order.  On the CPU the products are summed in
    numpy's pairwise order, one contiguous row per column, so the result
    is bitwise the same for any ``torch.get_num_threads()``: the CPU BLAS
    behind ``torch.dot`` splits the sum by thread count, and counts of
    the product-type methods move with that order.  bfloat16 (a bf16 inner
    solve): on CUDA cuBLAS sums in float32; on the CPU the bf16 products
    are summed in float32 in the same pairwise order; either rounds the
    sum once to bf16."""
    if a.device.type != "cpu":
        if a.dim() == 1:
            return torch.dot(a, b)
        return torch.stack([torch.dot(a[:, c], b[:, c]) for c in range(a.shape[1])])
    prod = a * b
    if prod.dtype == torch.bfloat16:
        return dot(prod.float(), prod.new_ones((), dtype=torch.float32)).to(torch.bfloat16)
    rows = np.ascontiguousarray(np.moveaxis(prod.numpy(), 0, -1))
    return torch.from_numpy(np.asarray(np.add.reduce(rows, axis=-1)))


def _dot_rows(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """⟨V[j], w⟩ for every row j of a basis V (m, n) (+ lane), each summed as
    ``dot`` sums one pair: on the CPU in one pairwise reduction of the m
    contiguous rows, on CUDA one ``torch.dot`` a row."""
    if V.device.type != "cpu":
        return torch.stack([dot(V[j], w) for j in range(V.shape[0])])
    return dot(V.movedim(0, -1), w.unsqueeze(-1)).movedim(-1, 0)


dot.rows = _dot_rows


# JAX's name for the one inner product (``lssp_tpu/solvers/base.vdot``, a
# multiply and a sum there because an fp64 dot_general is lossy on a TPU)
vdot = dot


def basis_combine(ym, V: torch.Tensor) -> torch.Tensor:
    """The correction Σ_i ym[i]·V[i] of a basis V (m, n) (JAX's
    ``basis_combine``): one row at a time, as the GMRES family forms its
    update; ``ym`` a tensor or a numpy vector of m coefficients."""
    ym = torch.as_tensor(ym).to(device=V.device, dtype=V.dtype)
    out = torch.zeros_like(V[0])
    for i in range(ym.shape[0]):
        out = out + ym[i] * V[i]
    return out


def dot_many(dot_fn, pairs):
    """The inner products ⟨aᵢ, bᵢ⟩ of ``pairs`` together: through
    ``dot_fn.many`` where it has one (the distributed dot: ONE reduction
    over the shards for all the pairs, ``parallel/dist_ops.make_psum_dot``),
    else one ``dot_fn`` call a pair, never a local sum that would skip a
    custom dot's reduction (JAX's ``solvers/base.dot_many``)."""
    many = getattr(dot_fn, "many", None)
    if many is not None:
        return many(pairs)
    return tuple(dot_fn(a, b) for a, b in pairs)


def dot_rows(dot_fn, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """All basis inner products ⟨V[j], w⟩ at once, the classical
    Gram-Schmidt primitive of cagmres: ``dot_fn.rows`` where it has one
    (the distributed dot: one reduction over the shards for the whole
    coefficient vector), else one ``dot_fn`` call a row (JAX's
    ``solvers/base.dot_rows``)."""
    rows = getattr(dot_fn, "rows", None)
    if rows is not None:
        return rows(V, w)
    return torch.stack([dot_fn(V[j], w) for j in range(V.shape[0])])


def norm(v: torch.Tensor, dot_fn=dot) -> torch.Tensor:
    """‖v‖ as √⟨v, v⟩ through ``dot_fn`` (``dot``, or a solve's own: the
    distributed one); (k,) column norms for an (n, k) block."""
    return torch.sqrt(dot_fn(v, v))


def operator(A) -> Callable:
    """Wrap a matrix container (or callable) as x ↦ A@x."""
    if callable(A) and not hasattr(A, "shape"):
        return A
    return lambda v: spmv(A, v)


def operator_t(A) -> Callable:
    """Wrap a matrix container as x ↦ Aᵀ@x (bicg, qmr, cgnr, lsqr).  A
    callable gives its transpose as a ``t_op`` attribute
    (``parallel/dist_ops.OpWithTranspose``); one without raises."""
    if callable(A) and not hasattr(A, "shape"):
        t_op = getattr(A, "t_op", None)
        if t_op is not None:
            return t_op
        raise TypeError("transpose-based solvers need a matrix container or an operator "
                        "with a .t_op transpose attribute; otherwise use a transpose-free "
                        "method")
    return lambda v: spmv_t(A, v)


def pc_transpose(M) -> Callable:
    """The M⁻ᵀ apply of a preconditioner: its ``t`` attribute (a
    ``Preconditioner``'s raises when none was installed).  A bare callable
    without ``t`` raises too: reusing M⁻¹ would corrupt the two-sided
    recurrences for a nonsymmetric M (a symmetric callable says so with
    ``M.t = M``)."""
    if M is None:
        return identity_pc
    t = getattr(M, "t", None)
    if t is not None:
        return t
    raise TypeError("transpose-based solvers need a preconditioner with an M^-T apply; "
                    "this callable M has no .t attribute: attach one (M.t = M if M is "
                    "symmetric) or use a transpose-free method (gmres/bicgstab/...)")


def stopping_tol(r0norm: float, bnorm: float, opts) -> float:
    """tol = max(rtol·‖r0‖, atol, rbtol·‖b‖) (reference solver-cg.cxx:66-70)."""
    return max(max(opts.rtol * r0norm, opts.atol), opts.rbtol * bnorm)


def identity_pc(r):
    """PC_NONE: solve = copy (reference pc.cxx:67-79)."""
    return r


def init_state(A, b, x0, M):
    """Common init: operators, x0 defaults to 0, r0 = b − A x0."""
    op = operator(A)
    pc = M if M is not None else identity_pc
    x = torch.zeros_like(b) if x0 is None else x0
    return op, pc, x, b - op(x)


def nonzero(t: torch.Tensor) -> torch.Tensor:
    """t where t ≠ 0, else 1 (the reference's guarded divisions)."""
    return torch.where(t == 0.0, torch.ones_like(t), t)


# rows per chunk of a Gram's batched product; for (2,097,152, 8) blocks on
# an H100, 2048 took 168 µs in fp32 against 214 µs for one flat GEMM and
# 282 µs for 8192 (fp64: 135, 142 and 120 µs)
GRAM_CHUNK = 2048


def chunked_gram(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """UᵀV over the rows of U (n, p) and V (n, k), the block solvers' every
    Gram and norm: the rows are cut into GRAM_CHUNK-row chunks, so the
    product is one batched GEMM of many short reductions summed over the
    chunks, plus one product for the n mod GRAM_CHUNK tail rows.  A few
    long (p, R)·(R, k) reductions with p, k ≤ 8 leave the card idle (on an
    H100, 8 ms a Gram at 128³ as eight per-shard products).  A distributed
    block is the (P, R, k) view of the same rows, so this is also its
    per-shard Gram summed over the shards (JAX's ``psum``), in another
    order."""
    p, k = U.shape[1], V.shape[1]
    m = U.shape[0] - U.shape[0] % GRAM_CHUNK
    G = (U[:m].reshape(-1, GRAM_CHUNK, p).mT @ V[:m].reshape(-1, GRAM_CHUNK, k)).sum(dim=0)
    return G + U[m:].mT @ V[m:] if m < U.shape[0] else G


def gram_norms(V: torch.Tensor) -> torch.Tensor:
    """The k column 2-norms of V, from its chunked Gram."""
    return torch.sqrt(torch.diagonal(chunked_gram(V, V)))


def reduced_grams(reduce=None):
    """(gram, gram_norms) of a block solver: ``chunked_gram`` and the column
    norms from it, each Gram passed through ``reduce`` first (JAX's
    ``reduce=``, the sum over the ranks of a distributed solve).  With
    ``reduce=None`` they are ``chunked_gram`` and ``gram_norms``."""
    if reduce is None:
        return chunked_gram, gram_norms

    def gram(U, V):
        return reduce(chunked_gram(U, V))

    def norms(V):
        return torch.sqrt(torch.diagonal(gram(V, V)))
    return gram, norms


def ridge(G: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """G + (64·eps/k)·(trace G + floor)·I: the relative ridge that keeps a
    rank-deficient Gram factorable."""
    k = G.shape[0]
    eps = torch.finfo(G.dtype).eps
    return G + (64.0 * eps / k) * (torch.trace(G) + floor) * torch.eye(
        k, dtype=G.dtype, device=G.device)


def to_host(*ts: torch.Tensor):
    """Each (k,) tensor as a numpy array, brought over in one transfer (one
    device sync); bools and ints stay exact."""
    host = torch.stack([t.to(torch.float64) for t in ts]).cpu().numpy()
    return tuple(host)


def history_init(opts, r0norm: float) -> Optional[np.ndarray]:
    """NaN-padded (maxit+1,) residual trace, or None when not recorded."""
    if not opts.record_history:
        return None
    h = np.full(opts.maxit + 1, np.nan)
    h[0] = r0norm
    return h


def history_update(opts, hist, it: int, res: float, r0norm=None, bnorm=None) -> None:
    """Record the trace and, at verbosity >= 1, print the reference's
    per-iteration line (reference solver-cg.cxx:108-112)."""
    if opts.verbosity >= 1:
        # level 0: SolverOptions.verbosity already asked for the trace
        if r0norm is not None and bnorm is not None:
            tiny = np.finfo(np.float64).tiny
            log(f"itr: {it:5d}, abs res: {res:.6e}, rel res: "
                f"{res / max(r0norm, tiny):.6e}, rbn: {res / max(bnorm, tiny):.6e}", level=0)
        else:
            log(f"itr: {it:5d}, abs res: {res:.6e}", level=0)
    if hist is not None and it < len(hist):
        hist[it] = res


def history_init_block(opts, k: int, r0norm, extra: int = 0) -> Optional[np.ndarray]:
    """The multi-rhs residual trace: a NaN-padded (k, maxit+1+extra) array,
    column c laid out as ``history_init``'s, or None when not recorded.
    ``extra`` is slack for a solver that steps past maxit inside a cycle
    (block GMRES), sliced back to maxit+1 by that solver."""
    if not opts.record_history:
        return None
    h = np.full((k, opts.maxit + 1 + extra), np.nan)
    h[:, 0] = r0norm
    return h


def history_update_block(opts, hist, it, res, r0norm=None, bnorm=None, cols=None) -> None:
    """Record the (k,) residuals ``res`` at iteration ``it`` (an int, or a
    (k,) array of per-column counts) for the columns ``cols`` (a bool mask;
    all when None) and, at verbosity >= 1, print one line with all k values
    in the scalar solvers' abs / rel / rbn format."""
    res = np.asarray(res, dtype=np.float64)
    if opts.verbosity >= 1:
        def fmt(a):
            return np.array2string(a, formatter={"float_kind": lambda v: f"{v:.6e}"})
        if r0norm is not None and bnorm is not None:
            tiny = np.finfo(np.float64).tiny
            log(f"itr: {np.max(it):5d}, abs res: {fmt(res)}, rel res: "
                f"{fmt(res / np.maximum(r0norm, tiny))}, rbn: "
                f"{fmt(res / np.maximum(bnorm, tiny))}", level=0)
        else:
            log(f"itr: {np.max(it):5d}, abs res: {fmt(res)}", level=0)
    if hist is None:
        return
    cols = np.ones(len(res), bool) if cols is None else np.asarray(cols)
    its = np.minimum(np.broadcast_to(it, res.shape), hist.shape[1] - 1)
    hist[cols, its[cols]] = res[cols]


def history_print_host(info: SolveInfo) -> None:
    """The recorded residual trace of a finished solve in the reference's
    line format, through ``utils.log`` (JAX prints it after the solve on
    backends without device prints; the port's solvers print each line as
    they go, so this serves a trace recorded with ``record_history``)."""
    if info.history is None:
        return
    h = np.asarray(info.history, dtype=np.float64)
    if h.ndim != 1 or h.size < 2:
        return
    tiny = float(np.finfo(h.dtype).tiny)
    r0 = max(float(info.r0norm), tiny)
    bn = max(float(info.bnorm), tiny)
    for it in range(1, min(int(info.nits), h.size - 1) + 1):
        res = float(h[it])
        if np.isnan(res):
            continue
        log(f"itr: {it:5d}, abs res: {res:.6e}, rel res: {res / r0:.6e}, "
            f"rbn: {res / bn:.6e}", level=0)


def history_print_host_multi(info: SolveInfo, k: int) -> None:
    """``history_print_host`` for a multi-rhs SolveInfo: an ``rhs c:``
    header and the column's trace, for each of the k columns."""
    for c in range(k):
        log(f"rhs {c}:", level=0)
        history_print_host(SolveInfo(
            *(np.asarray(getattr(info, f.name))[c] if getattr(info, f.name) is not None
              else None for f in dataclasses.fields(info))))
