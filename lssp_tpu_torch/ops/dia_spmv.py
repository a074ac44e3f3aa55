"""K1: the DIA stencil SpMV with its axpby epilogue (``csrc/dia_spmv.cu``),
and K1k, its k-rhs form.

``dia_spmv(A, x, alpha, beta, z)`` computes ``alpha·(A@x) + beta·z`` for a
DIA matrix.  On a CUDA tensor it launches the kernel (float32, float64 or
bfloat16; anything else raises); on a CPU tensor it runs ``dia_spmv_plain``, the same
function in plain PyTorch.  There is no fallback from one to the other.
Replaces ``lssp_tpu/ops/pallas_spmv.py: _dia_spmv_pallas``.

``dia_spmm(A, X, alpha, beta, Z)`` is the same on an (n, k) block (the
layout ``ops/spmv.py`` states) in one launch of K1k, the counterpart of the
k-rhs ``custom_vmap`` rule of ``_vmap_safe_kernel``; ``dia_spmm_plain`` is
its plain version.

bfloat16 (the inner precision of ``solve_ir``): every form loads bf16,
forms the products and the sum in float32, applies ``alpha`` / ``beta`` in
float32 and rounds once at the end (``acc_dtype``), in the kernel and in
its plain version alike, so the two agree to one bf16 ulp.

K1 and K3 in bfloat16 take one of two kernels, chosen on the host before
the launch by ``band_tile_plan`` (memoized) and counted in
``fn.by_route``: the band ring (``csrc/band_ring.cuh``: 1024-row tiles
streamed into shared memory by bulk copies, 8 rows a thread) where the
shape allows it, else the one-row-a-thread ("rowwise") kernel.  Both give
the same y bit for bit.  Neither is a fallback: a launch that fails raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.sparse.types import DIA

# The band ring's geometry (csrc/band_ring.cuh): rows a thread, the largest
# stage count and diagonal count it takes, the remainder entries a thread
# stages for K3, the dynamic shared memory a block may take (the H100's
# 227 KB opt-in less room for the kernel's static part) and an SM's 228 KB.
RING_ROWS = 8
RING_MAX_STAGES = 4
RING_MAX_DIAG = 64
RING_CHUNK = 2
RING_SMEM = 232448 - 1024
RING_SM_SMEM = 233472
# (tile rows, stages) in the order the plan tries them; T = 8 · threads.
# Of T in {512, 1024, 2048} × S in {2, 3, 4} on the H100 (chip_smoke.py
# phase 32 times them; PERF.md §6): K1 was fastest with four stages where
# two blocks still fit an SM (the 5-diagonal band past the L2), else with
# two (the 7-diagonal 128³ band, whose four stages leave one block); K3
# with two stages, which leave four blocks an SM to hide the remainder's
# gathers.
RING_SHAPES = {False: ((1024, 4), (1024, 2), (512, 2)), True: ((1024, 2), (512, 2))}
RING_TILES = (512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Which bf16 kernel a K1 / K3 launch takes, and the ring's geometry.

    ``route`` is "ring" or "rowwise" (``reason`` says why).  For the ring:
    ``T`` rows a tile (8 a thread, ``threads`` a block), ``S`` stages of
    ``stage_bytes`` each, ``smem`` dynamic shared bytes a block (with K3's
    chunk of ``chunk`` remainder entries), ``grid`` persistent blocks over
    ``ntiles`` tiles, and the interior tiles ``[t_lo, t_hi)`` (the others
    guard every x read)."""
    route: str
    reason: str = ""
    T: int = 0
    S: int = 0
    threads: int = 0
    stage_bytes: int = 0
    smem: int = 0
    chunk: int = 0
    ntiles: int = 0
    grid: int = 0
    t_lo: int = 0
    t_hi: int = 0

    @functools.cached_property
    def args(self) -> Tuple[int, ...]:
        """The ring entry's trailing arguments (before the stream)."""
        return (self.threads, self.S, self.grid, self.smem, self.t_lo, self.t_hi)


def _rowwise(reason: str) -> TilePlan:
    return TilePlan("rowwise", reason)


def ring_stage_bytes(T: int, nd: int, has_z: bool) -> int:
    """One stage: a T-row band slice and a (T + 8)-element x window for each
    diagonal, and the z slice (``csrc/band_ring.cuh: stage_bytes``)."""
    return nd * (2 * T + 8) * 2 + (2 * T if has_z else 0)


@functools.lru_cache(maxsize=256)
def band_tile_plan(n: int, ncols: int, offsets: Tuple[int, ...], itemsize: int,
                   has_z: bool, rem: bool = False, T: Optional[int] = None,
                   S: Optional[int] = None, num_sms: int = 132) -> TilePlan:
    """The kernel a K1 (``rem``: K3) launch of an (n, ncols) band with these
    diagonal ``offsets`` takes, for values of ``itemsize`` bytes and with or
    without z.  The ring needs 2-byte values, n and ncols multiples of 8,
    at most ``RING_MAX_DIAG`` diagonals and a stage that fits S ≥ 2 times
    (with K3's chunk) in ``RING_SMEM`` at T ≥ 512; ``T`` / ``S`` pin the
    shape (else the first of ``RING_SHAPES`` that fits, more than two
    stages only where two blocks fit an SM).  ``grid`` counts the blocks an
    SM holds by shared memory and by registers (the kernel's launch bound
    keeps 512 / threads blocks in the registers); the launch clamps it to
    the occupancy the driver reports.  Pointer alignment is checked per launch
    (``plan_launch``)."""
    offsets = tuple(int(o) for o in offsets)
    nd = len(offsets)
    if itemsize != 2:
        return _rowwise(f"the ring is the bf16 kernel; {itemsize}-byte values take the "
                        "rowwise kernel")
    if n == 0 or nd == 0:
        return _rowwise("an empty product (no rows or no diagonals)")
    if n % RING_ROWS or ncols % RING_ROWS:
        return _rowwise(f"n = {n} or ncols = {ncols} is not a multiple of {RING_ROWS}")
    if nd > RING_MAX_DIAG:
        return _rowwise(f"{nd} diagonals: the ring takes at most {RING_MAX_DIAG}")
    pinned = T is not None or S is not None
    if pinned:
        shapes = [(t, s) for t in ((T,) if T else RING_TILES) for s in ((S,) if S else (2,))]
    else:
        shapes = RING_SHAPES[bool(rem)]
    for t, s in shapes:
        if t not in RING_TILES or not 2 <= s <= RING_MAX_STAGES:
            return _rowwise(f"T = {t}, S = {s}: the ring takes T in 512 / 1024 / 2048 and "
                            f"S in 2..{RING_MAX_STAGES}")
        chunk = RING_CHUNK * (t // RING_ROWS) if rem else 0
        stage = ring_stage_bytes(t, nd, has_z)
        smem = s * stage + 12 * chunk
        per_sm = min(512 // (t // RING_ROWS), RING_SM_SMEM // (smem + 2048))
        if smem <= RING_SMEM and (pinned or s == 2 or per_sm >= 2):
            break
    else:
        t, s = shapes[-1]
        return _rowwise(f"{nd} diagonals need {ring_stage_bytes(t, nd, has_z)} bytes a stage "
                        f"at T = {t}: {s} stages do not fit {RING_SMEM} bytes of shared memory")
    threads = t // RING_ROWS
    ntiles = -(-n // t)
    per_sm = max(1, per_sm)
    lo, hi = min(offsets), max(offsets)
    t_lo = min(ntiles, -(-max(0, -lo) // t))
    t_hi = ntiles if n + hi <= ncols else max(0, min(ntiles - 1, (ncols - hi) // t))
    return TilePlan("ring", "", t, s, threads, stage, smem, chunk, ntiles,
                    min(ntiles, num_sms * per_sm), t_lo, t_hi)


MISALIGNED = _rowwise("a pointer is not 16-byte aligned")
NOT_BF16 = _rowwise("the ring is the bf16 kernel")
# the rowwise kernel on a shape the ring takes, for a caller that holds the
# two against each other (tests, chip_smoke.py)
ROWWISE = _rowwise("asked for by the caller")


def plan_launch(shape, offsets, data: torch.Tensor, x: torch.Tensor, z, y,
                rem: bool = False) -> TilePlan:
    """The memoized plan of a CUDA launch of K1 / K3, with the per-launch
    check that the band, x, z and y pointers are 16-byte aligned."""
    if x.dtype != torch.bfloat16:
        return NOT_BF16
    plan = band_tile_plan(shape[0], shape[1],
                          offsets if type(offsets) is tuple else tuple(offsets), 2, z is not None, rem,
                          num_sms=_kernels.num_sms(x.device))
    if plan.route == "ring" and (data.data_ptr() | x.data_ptr() | y.data_ptr()
                                 | (0 if z is None else z.data_ptr())) % 16:
        return MISALIGNED
    return plan


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a product of ``dtype`` operands sums in: float32 for
    bfloat16, else the dtype itself (the kernels' ``lssp::Acc``)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def shifted_sum(data: torch.Tensor, offsets, y: torch.Tensor) -> torch.Tensor:
    """Σ_d data[d, i]·y[i + off_d] with out-of-range reads as 0 — the DIA
    product in plain PyTorch (shared with the plain Neumann sweep).  ``y``
    is (m,) or an (m, k) block; a block's rows are shifted and each
    diagonal is broadcast over its k columns.  The sum is in
    ``acc_dtype``: float32 for bfloat16 operands, left unrounded."""
    n = data.shape[1]
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets) + n - y.shape[0]) if offsets else 0
    block = y.ndim == 2
    acc_dt = acc_dtype(torch.promote_types(data.dtype, y.dtype))
    data, y = data.to(acc_dt), y.to(acc_dt)
    yp = F.pad(y, (0, 0, lo, hi) if block else (lo, hi))
    acc = torch.zeros((n,) + tuple(y.shape[1:]), dtype=acc_dt, device=y.device)
    for d, off in enumerate(offsets):
        acc = acc + (data[d, :, None] if block else data[d]) * yp[lo + off:lo + off + n]
    return acc


def epilogue(y: torch.Tensor, alpha: float, beta: float, z: Optional[torch.Tensor],
             dtype: torch.dtype) -> torch.Tensor:
    """``alpha·y + beta·z`` on the sum y; for a bfloat16 product (``dtype``)
    in float32, rounded once at the end: the plain versions' counterpart of
    the kernels' store."""
    if alpha != 1.0:
        y = alpha * y
    if z is not None:
        y = y + beta * (z.float() if z.dtype == torch.bfloat16 else z)
    return y.to(dtype) if dtype == torch.bfloat16 else y


def dia_spmv_plain(data: torch.Tensor, offsets, x: torch.Tensor, alpha: float = 1.0,
                   beta: float = 0.0, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(Σ_d data[d]·shift(x, off_d)) + beta·z`` in plain PyTorch."""
    return epilogue(shifted_sum(data, offsets, x), alpha, beta, z,
                    torch.promote_types(data.dtype, x.dtype))


def dia_spmv(A: DIA, x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             z: Optional[torch.Tensor] = None, plan: Optional[TilePlan] = None) -> torch.Tensor:
    """``y = alpha·(A@x) + beta·z`` (``z`` optional).  CUDA tensors launch
    K1; CPU tensors take ``dia_spmv_plain``.  A bf16 launch takes the ring
    or the rowwise kernel as ``plan_launch`` says, or as ``plan`` (a
    ``band_tile_plan`` result, or ``ROWWISE``) pins it."""
    if x.device.type == "cpu":
        return dia_spmv_plain(A.data, A.offsets, x, alpha, beta, z)
    n, m = A.shape
    suf = _kernels.kernel_dtype("dia_spmv x", x)
    _kernels.check_cuda("dia_spmv data", A.data, x.dtype, (len(A.offsets), n))
    _kernels.check_cuda("dia_spmv x", x, x.dtype, (m,))
    if A.data.device != x.device:
        raise ValueError(f"dia_spmv: data on {A.data.device}, x on {x.device}")
    if z is not None:
        _kernels.check_cuda("dia_spmv z", z, x.dtype, (n,))
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if plan is None:
        plan = plan_launch(A.shape, A.offsets, A.data, x, z, y)
    lib, p = _kernels.load(), _kernels.ptr
    args = (p(A.data), p(A.offsets_t), len(A.offsets), n, m, p(x), float(alpha), float(beta),
            p(z), p(y))
    if plan.route == "ring":
        status = lib.lssp_dia_spmv_ring_bf16(*args, *plan.args, _kernels.stream_ptr(x.device))
    else:
        status = getattr(lib, f"lssp_dia_spmv_{suf}")(*args, _kernels.stream_ptr(x.device))
    _kernels.check_status("dia_spmv", status)
    _kernels.launched(dia_spmv, suf, plan.route)
    _kernels.check_nan("dia_spmv", y)
    return y


dia_spmv.launches = 0
dia_spmv.by_dtype = {}
dia_spmv.by_route = {}


def dia_spmm_plain(data: torch.Tensor, offsets, X: torch.Tensor, alpha: float = 1.0,
                   beta: float = 0.0, Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha·(A@X) + beta·Z`` on an (n, k) block in plain PyTorch: one
    shifted row slice of X per diagonal, the diagonal broadcast over the
    columns (the math of JAX's shifted-stream SpMM rule)."""
    if X.ndim != 2:
        raise ValueError(f"dia_spmm_plain: expected an (n, k) block, got {tuple(X.shape)}")
    return dia_spmv_plain(data, offsets, X, alpha, beta, Z)


def dia_spmm(A: DIA, X: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
             Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Y = alpha·(A@X) + beta·Z`` for an (n, k) block (``Z`` optional).
    CUDA tensors launch K1k once for all k columns; CPU tensors take
    ``dia_spmm_plain``."""
    if X.device.type == "cpu":
        return dia_spmm_plain(A.data, A.offsets, X, alpha, beta, Z)
    n, m = A.shape
    suf = _kernels.kernel_dtype("dia_spmm X", X)
    k = _kernels.check_block("dia_spmm X", X, X.dtype, m)
    _kernels.check_cuda("dia_spmm data", A.data, X.dtype, (len(A.offsets), n))
    if A.data.device != X.device:
        raise ValueError(f"dia_spmm: data on {A.data.device}, X on {X.device}")
    if Z is not None:
        _kernels.check_cuda("dia_spmm Z", Z, X.dtype, (n, k))
    Y = torch.empty(n, k, dtype=X.dtype, device=X.device)
    fn = getattr(_kernels.load(), f"lssp_dia_spmm_{suf}")
    status = fn(_kernels.ptr(A.data), _kernels.ptr(A.offsets_t), len(A.offsets), n, m, k,
                _kernels.ptr(X), float(alpha), float(beta), _kernels.ptr(Z),
                _kernels.ptr(Y), _kernels.stream_ptr(X.device))
    _kernels.check_status("dia_spmm", status)
    _kernels.launched(dia_spmm, suf)
    _kernels.check_nan("dia_spmm", Y)
    return Y


dia_spmm.launches = 0
dia_spmm.by_dtype = {}
