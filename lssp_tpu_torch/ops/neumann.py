"""K2: the truncated-Neumann ILU apply (``csrc/neumann.cu``).

z ≈ U⁻¹L⁻¹r by k sweeps ``y ← r − Ls·y``, then ``z0 = D⁻¹y``, then k sweeps
``z ← z0 − (D⁻¹Us)·z`` — the same math as the TPU kernel
``lssp_tpu/ops/pallas_neumann.py: _build_call``, whose whole apply sits in
VMEM.  Here the whole apply is ONE launch of ``lssp_neumann_apply``, a
wavefront over row tiles: work item (phase, u) carries tile u through
every sweep level of one phase, keeping its band rows and its own previous
level in shared memory, and reads the other tiles' levels from rings in
device memory (the L2) once their progress words say they are there.
``Wavefront`` is the schedule: the tiles, the rings and every set of items
an item waits for, which the kernel takes as arguments and only walks, so
the CPU tests check and replay what the kernel runs (the kernel's source
note says why it is deadlock-free and race-free).

The plan keeps the TPU plan's band/stray split (``split_band``: the up to
48 most-occupied diagonals holding ≥ 2% of n entries each), so the factors
are laid out as in ``lssp_tpu``; strays go in as row-sorted CSR.  The TPU
kernel is fp32 only; this one runs in the plan's dtype (float32 or
float64), and ``fused_neumann_apply`` requires ``r`` in that dtype, with
one exception: a bfloat16 ``r`` (the inner precision of ``solve_ir``) on a
float32 plan is cast to float32 for the apply and z cast back to bfloat16,
as JAX's ``fused_neumann_apply`` does (``pallas_neumann.py: _apply_impl``).
K2 itself takes no bfloat16.

On an (n, k) block (the layout ``ops/spmv.py`` states)
``fused_neumann_apply`` runs ``neumann_block_apply``: the same launch as
K2k, a register tile of up to 8 columns per thread (``csrc/krhs.cuh``), so
the factors are read once per level for all k columns, strays included —
JAX's k-rhs rule (``_vmap_safe_apply``) falls back to per-column kernel
calls when the factors have strays; this does not.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops.dia_spmv import shifted_sum
from lssp_tpu_torch.sparse.types import CSR, torch_dtype
from lssp_tpu_torch.sparse.utils import split_ldu, transpose

# the wavefront kernel (csrc/neumann.cu: kThreads, kMaxDiags,
# kMaxRanges; the launch rejects more): a block of THREADS threads, each
# owning up to lssp_neumann_rows_per_thread(kt) rows of a work item's tile
THREADS = 256
MAX_DIAGS = 64
MAX_RANGES = 16
# a tile's band rows in shared memory at most, past which tiles are halved
# (down to THREADS rows)
BAND_SMEM = 48 * 1024
# the level rings' bytes at most (2·(sweeps − 1) rings), past which the
# deep sweep counts of ilu_sweeps=-1 run fewer tiles at once
RING_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class NeumannFactor:
    """One strict triangular factor: DIA band plus CSR strays."""

    band: Any                   # (ndiag, n)
    offsets: tuple
    offsets_t: Any              # (ndiag,) int32, on band's device
    stray_ptr: Any = None       # (n+1,) int32, or None without strays
    stray_cols: Any = None      # (nstray,) int32
    stray_vals: Any = None      # (nstray,)


@dataclasses.dataclass(frozen=True)
class FusedNeumann:
    """Device state of the apply: the strict lower factor, the strict upper
    factor with rows pre-scaled by 1/diag, 1/diag, the sweep count, and the
    factors' reach (the largest |row − col| over band and strays)."""

    L: NeumannFactor
    U: NeumannFactor
    invdiag: Any                # (n,)
    n: int
    sweeps: int
    reach: int = 0

    @property
    def dtype(self):
        return self.invdiag.dtype


def split_band(S: CSR, n: int, max_diags: int = 48, min_occ: float = 0.02):
    """Band/stray split of a strict factor (host, numpy), the rule of
    ``lssp_tpu/ops/pallas_neumann.py: _split_band``.  Returns (band (nd, n)
    float64, offsets, (stray rows, cols, vals)); a factor with no kept
    diagonal gets one all-zero diagonal at offset 0."""
    ip = np.asarray(S.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(S.indices, dtype=np.int64)
    vals = np.asarray(S.data, dtype=np.float64)
    d = cols - rows
    offs, inv, counts = np.unique(d, return_inverse=True, return_counts=True)
    take = np.argsort(-counts, kind="stable")[:max_diags]
    take = take[counts[take] >= max(1, int(min_occ * n))]
    keep = np.zeros(len(offs), dtype=bool)
    keep[take] = True
    in_band = keep[inv]
    kept = np.sort(offs[keep])
    band = np.zeros((max(len(kept), 1), n), dtype=np.float64)
    if len(kept):
        band[np.searchsorted(kept, d[in_band]), rows[in_band]] = vals[in_band]
    offsets = tuple(int(o) for o in kept) if len(kept) else (0,)
    return band, offsets, (rows[~in_band], cols[~in_band], vals[~in_band])


def _factor(S: CSR, n, max_diags, min_occ, dtype, device):
    """(the factor on ``device``, its reach: the largest |row − col|)."""
    band, offsets, (rows, cols, vals) = split_band(S, n, max_diags, min_occ)
    reach = max(max(abs(o) for o in offsets), int(np.abs(rows - cols).max(initial=0)))
    f = NeumannFactor(band=torch.from_numpy(band).to(device=device, dtype=dtype),
                      offsets=offsets,
                      offsets_t=torch.tensor(offsets, dtype=torch.int32, device=device))
    if len(rows) == 0:
        return f, reach
    if len(rows) >= 2**31:
        raise ValueError(f"{len(rows)} stray entries overflow the int32 CSR")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return dataclasses.replace(
        f, stray_ptr=torch.from_numpy(ptr.astype(np.int32)).to(device),
        stray_cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        stray_vals=torch.from_numpy(vals).to(device=device, dtype=dtype)), reach


def _scaled_factors(L: CSR, U: CSR):
    """(Ls, D⁻¹Us, 1/diag) on the host: the strict factors of L and U, U's
    rows scaled by 1/diag in float64 (rounded once, at the upload)."""
    n = L.shape[0]
    Ls, _, _ = split_ldu(L)
    _, dU, Us = split_ldu(U)
    dU = np.asarray(dU, dtype=np.float64)
    inv = 1.0 / np.where(dU == 0, 1.0, dU)
    ipu = np.asarray(Us.indptr)
    urows = np.repeat(np.arange(n), ipu[1:] - ipu[:-1])
    return Ls, dataclasses.replace(Us, data=np.asarray(Us.data) * inv[urows]), inv


def _plan(F0: CSR, F1: CSR, inv, n, sweeps, max_diags, min_occ, dtype, device):
    (f0, reach0), (f1, reach1) = (_factor(S, n, max_diags, min_occ, dtype, device)
                                  for S in (F0, F1))
    return FusedNeumann(L=f0, U=f1, invdiag=torch.from_numpy(inv).to(device=device, dtype=dtype),
                        n=n, sweeps=int(sweeps), reach=max(reach0, reach1))


def plan_fused_neumann(L: CSR, U: CSR, sweeps: int, max_diags: int = 48,
                       min_occ: float = 0.02, dtype=None, device="cpu") -> FusedNeumann:
    """The apply's state on ``device`` from host factors L (strictly lower,
    unit diagonal implied) and U (upper with the diagonal).  ``dtype``
    (torch) defaults to U's dtype.  The scaled factor and 1/diag are formed
    in float64 and rounded once, as in the TPU plan."""
    if dtype is None:
        dtype = torch_dtype(np.asarray(U.data).dtype)
    Ls, Us, inv = _scaled_factors(L, U)
    return _plan(Ls, Us, inv, L.shape[0], sweeps, max_diags, min_occ, dtype, device)


def plan_fused_neumann_t(L: CSR, U: CSR, sweeps: int, max_diags: int = 48,
                         min_occ: float = 0.02, dtype=None, device="cpu") -> FusedNeumann:
    """The plan of the transposed apply z ≈ M⁻ᵀr = L⁻ᵀU⁻ᵀr for M = LU, from
    the same host factors as ``plan_fused_neumann``.  With U = D(I + D⁻¹Us),
    U⁻ᵀ = D⁻¹(I + (D⁻¹Us)ᵀ)⁻¹ and L⁻ᵀ = (I + Lsᵀ)⁻¹, so the transposed apply
    is K2's own apply on a plan whose phase-0 factor is (D⁻¹Us)ᵀ (strictly
    lower) and whose phase-1 factor is Lsᵀ (strictly upper), with the same
    1/diag: JAX's ``neumann_ilu_apply_t`` sweeps (``lssp_tpu/ops/
    trisolve.py:288-302``).  The factors keep K2's orientation (phase 0
    reads lower rows, phase 1 upper ones); their values are the forward
    plan's, moved, so the two plans hold the same numbers.  The band/stray
    split, the reach and the band reads are those of the transposed
    factors."""
    if dtype is None:
        dtype = torch_dtype(np.asarray(U.data).dtype)
    Ls, Us, inv = _scaled_factors(L, U)
    return _plan(transpose(Us), transpose(Ls), inv, L.shape[0], sweeps, max_diags, min_occ,
                 dtype, device)


def _factor_plain(F: NeumannFactor, y: torch.Tensor) -> torch.Tensor:
    """(Ls·y) or ((D⁻¹Us)·y) in plain PyTorch; ``y`` (n,) or (n, k)."""
    acc = shifted_sum(F.band, F.offsets, y)
    if F.stray_ptr is not None:
        n = y.shape[0]
        rows = torch.repeat_interleave(torch.arange(n, device=y.device),
                                       (F.stray_ptr[1:] - F.stray_ptr[:-1]).long(),
                                       output_size=F.stray_cols.shape[0])
        vals = F.stray_vals[:, None] if y.ndim == 2 else F.stray_vals
        acc = acc.index_add(0, rows, vals * y[F.stray_cols.long()])
    return acc


def neumann_apply_plain(plan: FusedNeumann, r: torch.Tensor) -> torch.Tensor:
    """The whole apply in plain PyTorch (the math of K2's 2k sweeps), on
    ``r`` (n,) or an (n, k) block (the math of K2k)."""
    invdiag = plan.invdiag[:, None] if r.ndim == 2 else plan.invdiag
    y = r
    for _ in range(plan.sweeps):
        y = r - _factor_plain(plan.L, y)
    z0 = invdiag * y
    z = z0
    for _ in range(plan.sweeps):
        z = z0 - _factor_plain(plan.U, z)
    return z


# ---------------------------------------------------------------------------
# the wavefront schedule of the kernel
# ---------------------------------------------------------------------------

def _ranges(deltas, cap: int = MAX_RANGES) -> tuple:
    """Sorted disjoint (lo, hi) ranges that cover ``deltas``, at most
    ``cap``: while there are more, the two nearest merge (an item that
    waits for more items is still right, only slower)."""
    out = []
    for d in sorted(set(deltas)):
        if out and d == out[-1][1] + 1:
            out[-1][1] = d
        else:
            out.append([d, d])
    while len(out) > cap:
        i = min(range(len(out) - 1), key=lambda i: out[i + 1][0] - out[i][1])
        out[i][1] = out.pop(i + 1)[1]
    return tuple((lo, hi) for lo, hi in out)


@dataclasses.dataclass(frozen=True)
class Wavefront:
    """The schedule of one apply, which the kernel (``csrc/neumann.cu``)
    takes as its arguments: tiles, rings and the wait sets.

    Work item (phase, u, c): row tile u ∈ [0, tiles) of ``rows`` rows, in
    column tile c, through all ``sweeps`` levels of a phase.  Phase 0
    (y ← r − Ls·y, the last level writes z0 = D⁻¹y) walks the tiles
    upward, tile t = u; phase 1 (z ← z0 − (D⁻¹Us)·z, the last level writes
    the output) downward, t = tiles − 1 − u.  Ticket x is item (x //
    ncols // tiles, x // ncols % tiles, x % ncols).  A level reads its own
    tile's previous level from the block's shared memory, the other
    tiles' from the level rings in device memory.

    A wait set is a tuple of (lo, hi) ranges of distances d: item u of a
    phase waits for items u − d of that phase's order (``waits`` lists
    them).  ``reads[ph]``: the tiles whose level s − 1 a level s > 1 reads
    (the factor's reach in tiles, or, without strays, only the tiles its
    band diagonals read); ``base``: phase 1's level 1 on z0, phase 0's
    last level; ``reuse[ph]``: before level s < sweeps overwrites the ring
    slots of tile u − ring_tiles, that tile and the tiles that read it
    finish level s + 1.

    Levels 1..sweeps−1 of a phase each live in a ring of ``ring_tiles``
    tiles, row i at slot i & mask (``ring_tiles == tiles``: full length);
    ring_tiles > dep keeps every wait on smaller tickets.  ``grid``
    blocks run at once."""

    n: int
    sweeps: int
    rows: int
    tiles: int
    dep: int
    ring_tiles: int
    ncols: int = 1
    grid: int = 1
    reads: tuple = ((), ())

    @property
    def ring_rows(self) -> int:
        return self.ring_tiles * self.rows

    @property
    def mask(self) -> int:
        """Ring slot of row i: i & mask (all ones for full-length rings)."""
        return self.ring_rows - 1 if self.ring_tiles < self.tiles else -1

    @property
    def tickets(self) -> int:
        return 2 * self.tiles * self.ncols

    @property
    def base(self) -> tuple:
        return _ranges([0] + [d for lo, hi in self.reads[1] for d in range(lo, hi + 1)])

    @property
    def reuse(self) -> tuple:
        if self.ring_tiles == self.tiles or self.sweeps == 1:
            return ((), ())
        return tuple(_ranges([self.ring_tiles] + [self.ring_tiles - d for lo, hi in rd
                                                 for d in range(lo, hi + 1)])
                     for rd in self.reads)

    def wait_sets(self) -> list:
        """The kernel's ``waits`` argument: reads[0], reads[1], base,
        reuse[0], reuse[1], each its count of ranges, then the ranges."""
        out = []
        for ranges in (*self.reads, self.base, *self.reuse):
            out += [len(ranges)] + [b for r in ranges for b in r]
        return out

    def item(self, x: int):
        """Ticket x → (phase, u, c)."""
        y = x // self.ncols
        return y // self.tiles, y % self.tiles, x % self.ncols

    def tile(self, ph: int, u: int) -> int:
        return self.tiles - 1 - u if ph else u

    def waits(self, ph: int, s: int, u: int):
        """What level s of item (ph, u) waits for before it computes, as
        the kernel walks the sets: (phase of the progress word, levels it
        must reach, tiles u' of phase ph's order, lowest, highest); a
        tile's progress word counts its levels done."""
        sets = []
        if s > 1:
            sets.append((ph, s - 1, self.reads[ph]))
        elif ph == 1:
            sets.append((0, self.sweeps, self.base))
        if s < self.sweeps:
            sets.append((ph, s + 1, self.reuse[ph]))
        return [(p, need, max(u - hi, 0), u - lo) for p, need, ranges in sets
                for lo, hi in ranges if u - lo >= 0]


def band_reads(plan: FusedNeumann):
    """The ``offsets`` of ``wavefront_schedule`` for a plan: per phase the
    factor's band offsets, or None when it has strays."""
    return tuple(None if F.stray_ptr is not None else F.offsets for F in (plan.L, plan.U))


def _read_distances(offsets, rows: int, dep: int, ph: int):
    """The distances d ≥ 1 of the tiles a level of phase ``ph`` reads: the
    first and last rows of each band diagonal, or the whole reach
    (``offsets`` None: strays)."""
    if offsets is None:
        return range(1, dep + 1)
    sign = 1 if ph else -1
    return [sign * (x // rows) for o in offsets for x in (o, o + rows - 1)
            if sign * (x // rows) >= 1]


def wavefront_schedule(n: int, reach: int, sweeps: int, rows: int, blocks: int,
                       ncols: int = 1, min_rows: int = None,
                       ring_budget: int = None, offsets=(None, None)) -> Wavefront:
    """The schedule for ``blocks`` thread blocks in flight: tiles of
    ``rows`` rows (a power of two), halved down to ``min_rows`` while the
    halved tiles still run in one wave (a phase's items at most
    ``blocks``: every wave costs an item's whole chain of levels, so a
    small n takes fewer, larger items); rings past the reach and the tiles
    in flight, a power of two of tiles, or full length when that is not
    smaller than n.  ``ring_budget`` caps a ring's rows (the deep sweeps of
    ``ilu_sweeps=-1``): the grid then shrinks so that the tiles in flight
    fit the ring.  ``offsets``: per phase the band offsets of a factor
    without strays, else None (``band_reads``)."""
    if sweeps < 1:
        raise ValueError("fused_neumann_apply needs sweeps >= 1")
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"rows per tile {rows}: a power of two (the ring slot is a mask)")
    while min_rows is not None and rows > min_rows and -(-n // (rows // 2)) * ncols <= blocks:
        rows //= 2
    tiles = max(1, -(-n // rows))
    dep = -(-reach // rows)
    grid = max(1, min(blocks, 2 * tiles * ncols))
    ring = 1 << (dep + -(-grid // ncols)).bit_length()     # > dep + tiles in flight
    if ring_budget is not None and ring * rows > ring_budget:
        ring = max(1 << dep.bit_length(), 1 << max(ring_budget // rows, 1).bit_length() - 1)
        grid = max(1, min(grid, (ring - dep - 1) * ncols))
    reads = tuple(_ranges(_read_distances(offsets[ph], rows, dep, ph)) for ph in (0, 1))
    return Wavefront(n=n, sweeps=sweeps, rows=rows, tiles=tiles, dep=dep,
                     ring_tiles=min(ring, tiles), ncols=ncols, grid=grid, reads=reads)


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def _check_plan(plan: FusedNeumann, device) -> None:
    n, dt = plan.n, plan.dtype
    _kernels.check_cuda("invdiag", plan.invdiag, dt, (n,))
    for name, F in (("L", plan.L), ("U", plan.U)):
        _kernels.check_cuda(f"{name}.band", F.band, dt, (len(F.offsets), n))
        _kernels.check_cuda(f"{name}.offsets", F.offsets_t, torch.int32)
        if len(F.offsets) > MAX_DIAGS:
            raise ValueError(f"{name}: {len(F.offsets)} diagonals, the kernel takes "
                             f"{MAX_DIAGS}")
        if F.stray_ptr is not None:
            _kernels.check_cuda(f"{name}.stray_ptr", F.stray_ptr, torch.int32, (n + 1,))
            _kernels.check_cuda(f"{name}.stray_cols", F.stray_cols, torch.int32)
            _kernels.check_cuda(f"{name}.stray_vals", F.stray_vals, dt,
                                F.stray_cols.shape)
        for t in (F.band, F.offsets_t, F.stray_ptr):
            if t is not None and t.device != device:
                raise ValueError(f"plan on {t.device}, r on {device}")


_blocks_in_flight = {}


def _blocks(lib, device, suf: str, kt: int, rows: int, hmax: int, nd: int) -> int:
    """Blocks of the kernel that fit on the card at once (occupancy × SMs)
    with tiles of ``rows`` rows, a window halo of ``hmax`` rows and ``nd``
    band rows in shared memory."""
    key = (device, suf, kt, rows, hmax, nd)
    if key not in _blocks_in_flight:
        with torch.cuda.device(device):
            got = getattr(lib, f"lssp_neumann_blocks_{suf}")(kt, rows, hmax, nd)
        if got <= 0:
            raise RuntimeError(f"lssp_neumann_blocks_{suf}: CUDA error {-got}")
        _blocks_in_flight[key] = got
    return _blocks_in_flight[key]


def tile_rows(rows_per_thread: int, itemsize: int, nd: int) -> int:
    """A tile's rows: THREADS × the rows a thread owns (the kernel's
    ``lssp_neumann_rows_per_thread``), halved while ``nd`` band rows of it
    would pass ``BAND_SMEM``."""
    rows = THREADS * rows_per_thread
    while rows > THREADS and nd * rows * itemsize > BAND_SMEM:
        rows //= 2
    return rows


def halo_rows(offsets, rows: int) -> int:
    """The rows beside a tile the kernel keeps in its window: the reach of
    the diagonals within one tile (the others are read through the L2)."""
    return max([abs(o) for o in offsets if abs(o) <= rows], default=0)


def _tile_width(k: int, itemsize: int, *tensors) -> int:
    """``csrc/krhs.cuh: tile_width``: the largest of 8, 4, 2 that divides k
    with every block pointer aligned for its vector loads, else 1."""
    for kt in (8, 4, 2):
        align = min(16, kt * itemsize)
        if k % kt == 0 and all(t.data_ptr() % align == 0 for t in tensors):
            return kt
    return 1


def launch_schedule(plan: FusedNeumann, r: torch.Tensor, *outputs):
    """(the Wavefront, the tile width kt, the two factors' halos) of one
    launch on ``r`` (n,) or (n, k), a CUDA tensor, writing ``outputs``."""
    k = 1 if r.ndim == 1 else r.shape[1]
    suf = _kernels.kernel_dtype("fused_neumann_apply r", r, _kernels.NEUMANN_DTYPES)
    lib = _kernels.load()
    kt = _tile_width(k, r.element_size(), r, *outputs)
    nd = max(len(plan.L.offsets), len(plan.U.offsets))
    rpt = getattr(lib, f"lssp_neumann_rows_per_thread_{suf}")(kt)
    rows = tile_rows(rpt, r.element_size(), nd)
    hmax = max(halo_rows(F.offsets, rows) for F in (plan.L, plan.U))
    sched = wavefront_schedule(plan.n, plan.reach, plan.sweeps, rows,
                               _blocks(lib, r.device, suf, kt, rows, hmax, nd), k // kt,
                               min_rows=THREADS,
                               ring_budget=RING_BYTES // (2 * max(plan.sweeps - 1, 1) * k
                                                          * r.element_size()),
                               offsets=band_reads(plan))
    if sched.tickets >= 2**31:
        raise ValueError(f"{sched.tickets} work items overflow the int32 ticket")
    # halving the tiles for a small n only shrinks the shared memory, so
    # the blocks counted above still fit
    return sched, kt, [halo_rows(F.offsets, sched.rows) for F in (plan.L, plan.U)]


def _apply(plan: FusedNeumann, r: torch.Tensor, k: int, counter) -> torch.Tensor:
    """One launch of the wavefront kernel for ``r`` (n,) (k = 1) or (n, k);
    adds one to ``counter.launches``."""
    if plan.sweeps < 1:
        raise ValueError("fused_neumann_apply needs sweeps >= 1")
    _check_plan(plan, r.device)
    z0, out = torch.empty_like(r), torch.empty_like(r)
    sched, kt, halos = launch_schedule(plan, r, z0, out)
    suf = _kernels.SUFFIX[r.dtype]
    levels = r.new_empty(2 * (plan.sweeps - 1) * sched.ring_rows * k)
    flags = torch.empty(2 * sched.ncols * sched.tiles + 1, dtype=torch.int32,
                        device=r.device)
    waits = sched.wait_sets()
    p = _kernels.ptr
    args = []
    for F in (plan.L, plan.U):
        args += [p(F.band), p(F.offsets_t), len(F.offsets), p(F.stray_ptr), p(F.stray_cols),
                 p(F.stray_vals)]
    status = getattr(_kernels.load(), f"lssp_neumann_apply_{suf}")(
        *args, p(plan.invdiag), plan.n, k, p(r), p(z0), p(out), p(levels), sched.ring_rows,
        sched.mask, p(flags), sched.sweeps, sched.rows, sched.tiles,
        (ctypes.c_int * len(waits))(*waits), *halos, kt, sched.grid,
        _kernels.stream_ptr(r.device))
    _kernels.check_status(f"lssp_neumann_apply_{suf}", status)
    _kernels.launched(counter, suf)
    _kernels.check_nan(f"lssp_neumann_apply_{suf}", out)
    return out


def _bf16_on_fp32(plan: FusedNeumann, r: torch.Tensor) -> bool:
    """Whether ``r`` is a bfloat16 operand of a float32 plan, which the
    apply takes in float32 and hands back in bfloat16."""
    return r.dtype == torch.bfloat16 and plan.dtype == torch.float32


def fused_neumann_apply(plan: FusedNeumann, r: torch.Tensor) -> torch.Tensor:
    """z ≈ U⁻¹L⁻¹r.  CUDA tensors run K2, one launch an apply (an (n, k)
    block goes to ``neumann_block_apply``, K2k); CPU tensors take
    ``neumann_apply_plain``.  ``r`` must have the plan's dtype, or be
    bfloat16 on a float32 plan (cast in and out around the apply)."""
    if _bf16_on_fp32(plan, r):
        return fused_neumann_apply(plan, r.float()).to(torch.bfloat16)
    if r.dtype != plan.dtype:
        raise TypeError(f"fused_neumann_apply: r is {r.dtype}, the plan {plan.dtype}")
    if r.device.type == "cpu":
        return neumann_apply_plain(plan, r)
    if r.ndim == 2:
        return neumann_block_apply(plan, r)
    _kernels.check_cuda("fused_neumann_apply r", r, plan.dtype, (plan.n,))
    return _apply(plan, r, 1, fused_neumann_apply)


fused_neumann_apply.launches = 0
fused_neumann_apply.by_dtype = {}


def neumann_block_apply(plan: FusedNeumann, R: torch.Tensor) -> torch.Tensor:
    """Z ≈ U⁻¹L⁻¹R for an (n, k) block.  CUDA tensors run K2k, one launch
    an apply over all k columns; CPU tensors take ``neumann_apply_plain``.
    ``R`` must have the plan's dtype, or be bfloat16 on a float32 plan."""
    if _bf16_on_fp32(plan, R):
        return neumann_block_apply(plan, R.float()).to(torch.bfloat16)
    if R.dtype != plan.dtype:
        raise TypeError(f"neumann_block_apply: R is {R.dtype}, the plan {plan.dtype}")
    if R.device.type == "cpu":
        return neumann_apply_plain(plan, R)
    k = _kernels.check_block("neumann_block_apply R", R, plan.dtype, plan.n)
    if k == 0:
        return torch.empty_like(R)
    return _apply(plan, R, k, neumann_block_apply)


neumann_block_apply.launches = 0
neumann_block_apply.by_dtype = {}
