"""Distributed solve: partition on the host, iterate over a shard mesh.

The JAX package runs the whole Krylov iteration inside one ``shard_map``
over a 1-D device mesh.  Here a ``Mesh`` is the shard slots of one
process on its one ``torch.device``, over the ranks of an optional
``torch.distributed`` group (one rank per device, ``multihost.py``): each
partitioned matrix and preconditioner state keeps its leading shard axis
as a tensor dimension, vectors stay flat (the rank's rows), and the
port's methods run unchanged on the distributed operator
(``dist_ops.make_dist_spmv``), preconditioner (``_shard_pc_apply``) and
dot (``dist_ops.make_psum_dot``).  So eight shards run, with every shard
boundary, on one H100 or one CPU, or over W ranks with 8 / W shards each.

Over ranks, every rank runs the same host build (padding, format, the
per-shard factors and the choices made from them) and uploads only its
own shards; b and x0 are cut to its rows, x is all-gathered at the end,
and every branch of a solve follows a value reduced over all the ranks,
so every rank takes the same steps and returns the same x and SolveInfo.
Without a group the mesh communicates nothing.

Preconditioning is block-Jacobi ILU (each shard factors its diagonal block
and applies it with no exchange, by Neumann sweeps through kernel K4 or
by exact level schedules) or a distributed AMG hierarchy: ``saamg``
(``dist_sa``: shard-local reshape transfers, every banded level product
through K4), ``rsamg`` (``dist_rs``: the classical hierarchy through the
same cycle, or the flat saamg plan when the matrix is no shard-alignable
lattice) and ``amg`` (``dist_amg``: padded-ELL gathers).  Every rank
builds the whole hierarchy on the host and keeps its shards; the cycles
exchange halos, gather the Spike interface, the classical levels'
vectors and the coarsest vector over the ranks.

The transpose methods (bicg, qmr, cgnr, lsqr) take the operator with its
transpose (``dist_ops.OpWithTranspose``: ``make_dist_spmv_t``, plain
PyTorch) and a preconditioner with its shard-local M⁻ᵀ: the identity,
Jacobi, or block-Jacobi ILU, whose transposed sweeps run kernel K4 on the
transposed shard bands (or the exact transposed level schedules).  The
AMG hierarchies have no transpose apply and are refused for them, as in
JAX.

``dist_solve_multi`` / ``dist_solve_ir_multi`` take B (n, k): blocks are
the (P, R, k) view of the (n, k) layout of ``ops/spmv.py``, so every DIA
product and every Neumann sweep is one launch of K4k for all shards and
columns.  A block method (``blockcg``, ``blockgmres``) takes each Gram
over the flat rows (``solvers/base.chunked_gram``), which is the sum of
the per-shard Grams; any other method runs its per-column batched form.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lssp_tpu_torch.config import (
    Defaults, PCOptions, SolverOptions, resolve_device, smoother_degree,
)
from lssp_tpu_torch.ops.trisolve import (
    TriSchedule, _sweep, default_ilu_sweeps, ilu_transpose_schedules, level_schedule,
    neumann_exact_depth,
)
from lssp_tpu_torch.parallel.dist_ops import (
    OpWithTranspose, _dia_local_spmv, gather_rows, make_dist_spmv, make_dist_spmv_t,
    make_psum_dot, rank_sum,
)
from lssp_tpu_torch.parallel.partition import DistDIA, partition_matrix
from lssp_tpu_torch.pc.base import cast_state, round_factor, rounding_to
from lssp_tpu_torch.pc.ilu_host import iluk_factor, ilut_factor
from lssp_tpu_torch.solvers.base import norm
from lssp_tpu_torch.solvers.facade import (
    check_input, needs_transpose_pc, place_system, solver_for,
)
from lssp_tpu_torch.solvers.refine import _inner_plan, refine, refine_multi
from lssp_tpu_torch.solvers.registry import get_block_solver
from lssp_tpu_torch.sparse.convert import coo_to_csr
from lssp_tpu_torch.sparse.types import COO, CSR, round_to, torch_dtype
from lssp_tpu_torch.sparse.utils import diagonal, split_ldu
from lssp_tpu_torch.utils.memo import _pc_options_key, fingerprint, memo_get, memo_put
from lssp_tpu_torch.utils.profile import annotate
from lssp_tpu_torch.utils.tree import map_tensors

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard slots on its one device, repeats allowed (P
    slots on one card), over the ranks of ``group`` (a ``torch.distributed``
    process group, or None for one process).  Every rank holds as many
    slots; rank r owns the global shards [r·slots, (r+1)·slots).  Slots on
    more than one distinct device raise ``NotImplementedError``: one
    process drives one device.  The group (equal and hashed by identity),
    ``rank`` and ``world`` are part of the mesh's equality and hash, so two
    groups over one device never share a memo entry."""

    devices: Tuple[torch.device, ...]
    group: Any = dataclasses.field(default=None, repr=False)
    rank: int = dataclasses.field(default=0, init=False)
    world: int = dataclasses.field(default=1, init=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # "cuda" and "cuda:0" name one card: compare (and hash) resolved names
        object.__setattr__(self, "devices", tuple(resolve_device(d) for d in self.devices))
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"a mesh over {len(set(self.devices))} distinct devices in one process: run "
                "one process per device (torchrun) and build its mesh with "
                "multihost.initialize() and multihost.global_mesh()")
        if self.group is not None:
            import torch.distributed as dist
            backend = dist.get_backend(self.group)
            if (backend == "nccl") != (self.device.type == "cuda"):
                raise ValueError(f"a {backend} process group cannot reach {self.device}: "
                                 "NCCL for a CUDA device, gloo for the CPU")
            object.__setattr__(self, "rank", dist.get_rank(self.group))
            object.__setattr__(self, "world", dist.get_world_size(self.group))

    @property
    def slots(self) -> int:
        """This rank's shards."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count, over every rank."""
        return self.world * self.slots

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(ndevices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D shard mesh.  ``devices``: a sequence of devices, one per slot
    (``[torch.device("cuda:0")] * 8`` is eight shards on one card,
    ``["cpu"] * 8`` eight on the CPU).  The default is one slot per visible
    GPU, cut to the first ``ndevices``; with no GPU it raises (name the CPU
    slots explicitly)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[\"cpu\"] * P "
                               "for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if ndevices is not None:
            devices = devices[:ndevices]
    return Mesh(tuple(devices))


def _extract_diag_block(A: CSR, lo: int, hi: int) -> CSR:
    """Rows and columns [lo, hi) of A."""
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    R = hi - lo
    rows = np.repeat(np.arange(lo, hi, dtype=np.int64), ip[lo + 1:hi + 1] - ip[lo:hi])
    sl = slice(ip[lo], ip[hi])
    keep = (idx[sl] >= lo) & (idx[sl] < hi)
    p = np.zeros(R + 1, dtype=np.int64)
    np.add.at(p, rows[keep] - lo + 1, 1)
    return CSR(np.cumsum(p).astype(np.int32), (idx[sl][keep] - lo).astype(np.int32),
               dat[sl][keep], (R, R))


def _csr_to_dia_rows(S: CSR, offsets, R: int) -> np.ndarray:
    """Shard-local CSR → row-aligned DIA data on a fixed offset set."""
    ip = np.asarray(S.indptr).astype(np.int64)
    rows = np.repeat(np.arange(R, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(S.indices).astype(np.int64)
    data = np.zeros((len(offsets), R), dtype=np.asarray(S.data).dtype)
    data[np.searchsorted(np.asarray(offsets), cols - rows), rows] = np.asarray(S.data)
    return data


def _entry_offsets(S: CSR, R: int) -> np.ndarray:
    ip = np.asarray(S.indptr).astype(np.int64)
    rows = np.repeat(np.arange(R, dtype=np.int64), ip[1:] - ip[:-1])
    return np.unique(np.asarray(S.indices).astype(np.int64) - rows)


@dataclasses.dataclass(frozen=True)
class StackedSchedule:
    """Per-shard padded level schedules of one factor, padded to a common
    shape and stacked on a leading shard axis (JAX's ``_stack_schedules``):
    one batched gather, row sum and scatter a level for every shard."""

    rows: Any           # (P, nlev, w) int64, padded with R
    cols: Any           # (P, nlev, w, k) int64, padded with R
    vals: Any           # (P, nlev, w, k), padded with 0
    invdiag: Any        # (P, R) 1/diag (1 where a shard has none), or None
    n: int              # R


def _stack_shape(scheds):
    """The common (nlev, w, k) of per-shard ``TriSchedule``s."""
    return (max(s.rows.shape[0] for s in scheds), max(s.rows.shape[1] for s in scheds),
            max(s.cols.shape[2] for s in scheds))


def _stack_schedules(scheds, R: int) -> StackedSchedule:
    """Pad per-shard ``TriSchedule``s to a common (nlev, w, k) and stack
    them (``lssp_tpu/parallel/dist_solve.py:_stack_schedules``): padded rows
    and columns point at the dummy slot R, padded values are 0, a missing
    diagonal is 1."""
    NL, W, K = _stack_shape(scheds)
    P, dev = len(scheds), scheds[0].vals.device
    rows = torch.full((P, NL, W), R, dtype=torch.int64, device=dev)
    cols = torch.full((P, NL, W, K), R, dtype=torch.int64, device=dev)
    vals = scheds[0].vals.new_zeros((P, NL, W, K))
    has_diag = any(s.invdiag is not None for s in scheds)
    invd = scheds[0].vals.new_ones((P, R)) if has_diag else None
    for p, s in enumerate(scheds):
        nl, w = s.rows.shape
        k = s.cols.shape[2]
        rows[p, :nl, :w] = s.rows
        cols[p, :nl, :w, :k] = s.cols
        vals[p, :nl, :w, :k] = s.vals
        if s.invdiag is not None:
            invd[p] = s.invdiag
    return StackedSchedule(rows, cols, vals, invd, R)


def _stack_or_list(scheds, nnz: int, R: int):
    """The shards' schedules of one factor stacked while the stacked padded
    layout holds at most twice the factors' strict nnz (ROADMAP C 14's
    rule), else the per-shard list."""
    if all(isinstance(s, TriSchedule) for s in scheds) \
            and len(scheds) * np.prod(_stack_shape(scheds)) <= 2 * nnz:
        return _stack_schedules(scheds, R)
    return list(scheds)


def _sweep_stacked(S: StackedSchedule, b2: torch.Tensor) -> torch.Tensor:
    """Every shard's exact triangular solve of b2 (P, R[, k]) at once: a
    loop over the levels, each a gather, a row sum and a scatter into the
    extended iterate (slot R is a dummy that stays 0)."""
    P, R = b2.shape[:2]
    tail = tuple(b2.shape[2:])
    pad = b2.new_zeros((P, 1) + tail)
    be = torch.cat([b2, pad], dim=1)
    vals = S.vals.to(b2.dtype)
    ide = None
    if S.invdiag is not None:
        ide = torch.cat([S.invdiag.to(b2.dtype), b2.new_ones((P, 1))], dim=1)
        if tail:
            ide = ide[..., None]
    if tail:
        vals = vals[..., None]
    shard = torch.arange(P, device=b2.device)
    xe = torch.zeros_like(be)
    for lev in range(S.rows.shape[1]):
        rows = S.rows[:, lev]
        s = be[shard[:, None], rows] - (vals[:, lev] * xe[shard[:, None, None],
                                                         S.cols[:, lev]]).sum(dim=2)
        if ide is not None:
            s = s * ide[shard[:, None], rows]
        xe[shard[:, None], rows] = s
    return xe[:, :R]


def _sweep_shards(S, b2: torch.Tensor) -> torch.Tensor:
    """One factor's exact solve on every shard: stacked, or shard by shard."""
    if isinstance(S, StackedSchedule):
        return _sweep_stacked(S, b2)
    return torch.stack([_sweep(s, b2[p]) for p, s in enumerate(S)])


@dataclasses.dataclass(frozen=True)
class _DistNeumannILU:
    """Per-shard strict factors on the union offset set, for Neumann sweeps
    that each stream one shard-local band (kernel K4 on CUDA).  ``Lt`` and
    ``Ut`` (set for a transpose method) are the shard-local transposes of
    ``L`` and ``U``, the bands of the M⁻ᵀ sweeps."""

    L: DistDIA              # strict lower, data (P, ndl, R)
    U: DistDIA              # strict upper scaled by 1/diag, (P, ndu, R)
    invdiag: Any            # (P, R)
    sweeps: int
    Lt: Optional[DistDIA] = None
    Ut: Optional[DistDIA] = None

    def to(self, device) -> "_DistNeumannILU":
        def move(T):
            return None if T is None else T.to(device)
        return dataclasses.replace(self, L=self.L.to(device), U=self.U.to(device),
                                   invdiag=self.invdiag.to(device), Lt=move(self.Lt),
                                   Ut=move(self.Ut))


def shard_transpose(T: DistDIA) -> DistDIA:
    """The shard-local transpose of a block-diagonal DistDIA (no entry
    crosses a shard): diagonal off becomes −off, its row r moved to row
    r + off.  Values move only, so they equal ``T``'s bitwise."""
    P, nd, R = T.data.shape
    offs = tuple(sorted(-o for o in T.offsets))
    data = T.data.new_zeros((P, nd, R))
    for d, off in enumerate(T.offsets):
        lo, hi = max(0, -off), min(R, R - off)
        if hi > lo:
            data[:, offs.index(-off), lo + off:hi + off] = T.data[:, d, lo:hi]
    return DistDIA(data, offs, T.n, T.nshards)


@dataclasses.dataclass(frozen=True)
class _DistNeumannILUDyn:
    """Per-shard offset sets as data (padded to the widest shard with
    offset-0 slots that carry zero data): keeps the sweeps when the union
    of the shards' offsets exceeds the cap but each shard's factor stays
    narrow.  Plain torch gathers, as JAX runs this path in XLA."""

    Ldata: Any              # (P, ndl, R)
    Loff: Any               # (P, ndl) int64
    Udata: Any              # (P, ndu, R)
    Uoff: Any               # (P, ndu) int64
    invdiag: Any            # (P, R)
    sweeps: int

    def to(self, device) -> "_DistNeumannILUDyn":
        return dataclasses.replace(self, Ldata=self.Ldata.to(device), Loff=self.Loff.to(device),
                                   Udata=self.Udata.to(device), Uoff=self.Uoff.to(device),
                                   invdiag=self.invdiag.to(device))


def _build_dist_ilu_neumann(factors, Pn: int, R: int, sweeps: int, max_union: int = 96):
    """Stack the per-shard (L, U) factors for Neumann sweeps: a
    ``_DistNeumannILU`` on the union offsets, a ``_DistNeumannILUDyn`` when
    the union exceeds ``max_union`` but no shard does, else None (exact
    schedules then)."""
    Ls_list, Us_list, inv_list = [], [], []
    offL, offU = set(), set()
    for L, U in factors:
        _, d, Us = split_ldu(U)
        d = np.where(d == 0, 1.0, d)
        # cast before scaling, or a float32 factor widens to float64
        inv = (1.0 / d).astype(np.asarray(U.data).dtype)
        ip = np.asarray(Us.indptr)
        rr = np.repeat(np.arange(R), ip[1:] - ip[:-1])
        Us_s = CSR(Us.indptr, Us.indices, np.asarray(Us.data) * inv[rr], Us.shape)
        Ls, _, _ = split_ldu(L)
        Ls_list.append(Ls)
        Us_list.append(Us_s)
        inv_list.append(inv)
        offL.update(_entry_offsets(Ls, R).tolist())
        offU.update(_entry_offsets(Us_s, R).tolist())
    offL = tuple(sorted(offL)) or (0,)
    offU = tuple(sorted(offU)) or (0,)
    if sweeps == -1:        # exact: the complete series, to the dependency depth
        sweeps = neumann_exact_depth(
            [(S.indptr, S.indices, R, lower)
             for S_list, lower in ((Ls_list, True), (Us_list, False)) for S in S_list])
    invdiag = torch.from_numpy(np.stack(inv_list))
    if len(offL) > max_union or len(offU) > max_union:
        offsL = [_entry_offsets(S, R) for S in Ls_list]
        offsU = [_entry_offsets(S, R) for S in Us_list]
        ndl = max(max((len(o) for o in offsL), default=0), 1)
        ndu = max(max((len(o) for o in offsU), default=0), 1)
        if ndl > max_union or ndu > max_union:
            return None

        def pad(o, nd):
            # offset 0 is never a strict-factor offset, so its slots hold
            # zero data; sorted, as _csr_to_dia_rows' searchsorted needs
            return np.sort(np.concatenate([o, np.zeros(nd - len(o), np.int64)]))
        Loff = [pad(o, ndl) for o in offsL]
        Uoff = [pad(o, ndu) for o in offsU]
        return _DistNeumannILUDyn(
            Ldata=torch.from_numpy(np.stack([_csr_to_dia_rows(S, o, R)
                                             for S, o in zip(Ls_list, Loff)])),
            Loff=torch.from_numpy(np.stack(Loff)),
            Udata=torch.from_numpy(np.stack([_csr_to_dia_rows(S, o, R)
                                             for S, o in zip(Us_list, Uoff)])),
            Uoff=torch.from_numpy(np.stack(Uoff)), invdiag=invdiag, sweeps=int(sweeps))
    n = Pn * R
    L = DistDIA(torch.from_numpy(np.stack([_csr_to_dia_rows(S, offL, R) for S in Ls_list])),
                offL, n, Pn)
    U = DistDIA(torch.from_numpy(np.stack([_csr_to_dia_rows(S, offU, R) for S in Us_list])),
                offU, n, Pn)
    return _DistNeumannILU(L, U, invdiag, int(sweeps))


def _build_dist_amg_pc(A: CSR, pc_type, pc_opts: PCOptions, Pn: int, device, sa_grid):
    """The distributed AMG preconditioners (``lssp_tpu/parallel/dist_solve.py:
    239-293``): ``(kind, hierarchy)`` with kind "amg" (``dist_amg``) or
    "saamg" (a ``DistSA``, also for rsamg).  ``sa_grid``: the launcher's
    saamg grid dims (False: flat), which its padding plan followed."""
    from lssp_tpu_torch.parallel.dist_sa import build_dist_sa
    dtype = np.asarray(A.data).dtype
    degree = smoother_degree(pc_opts.amg_presmooth, pc_opts.amg_postsmooth)
    if pc_type == "amg":
        from lssp_tpu_torch.amg.setup import amg_setup
        from lssp_tpu_torch.parallel.dist_amg import build_dist_amg
        hier = amg_setup(A, theta=pc_opts.amg_theta, max_levels=pc_opts.amg_max_levels,
                         coarse_size=pc_opts.amg_coarse_size,
                         smooth_interp=pc_opts.amg_smooth_interp, trunc=pc_opts.amg_trunc)
        return "amg", build_dist_amg(hier, Pn, dtype=dtype, degree=degree, device=device)
    if pc_type == "rsamg":
        from lssp_tpu_torch.parallel.dist_rs import build_dist_rs
        sm = pc_opts.amg_smoother
        h = build_dist_rs(A, Pn, theta=pc_opts.amg_theta, max_levels=pc_opts.amg_max_levels,
                          coarse_size=max(pc_opts.amg_coarse_size, 4 * Pn),
                          smoother="chebyshev" if sm in ("l1jacobi", "line") else sm,
                          degree=degree, dtype=dtype, max_pdiags=pc_opts.amg_max_pdiags,
                          device=device)
        if h is not None:
            return "saamg", h
        warnings.warn("dist pc='rsamg': matrix is not a shard-alignable lattice; using "
                      "the distributed structured-SA hierarchy instead", RuntimeWarning,
                      stacklevel=4)
        sa_grid = False
    # "line" passes through: the Spike solve is exact across shard boundaries
    sm = "jacobi" if pc_opts.amg_smoother == "l1jacobi" else pc_opts.amg_smoother
    return "saamg", build_dist_sa(A, Pn, g=pc_opts.saamg_aggregate,
                                  max_levels=pc_opts.amg_max_levels,
                                  coarse_size=pc_opts.amg_coarse_size, smoother=sm,
                                  grid=sa_grid, degree=degree, dtype=dtype, device=device)


TRANSPOSE_PCS = (None, "none", "jacobi", "bjilu", "iluk", "ilu0", "ilut")
AMG_PCS = ("amg", "rsamg", "saamg")


def _build_dist_pc(A: CSR, pc_type, pc_opts: PCOptions, Pn: int, R: int, device,
                   sa_grid=False):
    """``(kind, state)`` with the state's tensors on ``device``; ``kind``
    selects the apply in ``_shard_pc_apply``.  ``pc_opts.transpose`` also
    builds the shard-local M⁻ᵀ state of block-Jacobi ILU."""
    if pc_type in (None, "none"):
        return "none", None
    if pc_type == "jacobi":
        d = diagonal(A).copy()
        small = np.abs(d) < Defaults.ZERO_DIAG_TOL
        d[small] = np.where(d[small] > 0, Defaults.ZERO_DIAG_VALUE, -Defaults.ZERO_DIAG_VALUE)
        return "jacobi", torch.from_numpy((pc_opts.omega / d).reshape(Pn, R)).to(device)
    if pc_type in AMG_PCS:
        return _build_dist_amg_pc(A, pc_type, pc_opts, Pn, device, sa_grid)
    if pc_type not in ("bjilu", "iluk", "ilu0", "ilut"):
        raise ValueError(f"unsupported distributed pc {pc_type!r}")
    factors = []
    for p in range(Pn):
        blk = _extract_diag_block(A, p * R, (p + 1) * R)
        if pc_type == "ilut":
            LU = ilut_factor(blk, tol=pc_opts.ilut_tol, p=pc_opts.ilut_p)
        else:
            LU = iluk_factor(blk, level=0 if pc_type == "ilu0" else pc_opts.iluk_level)
        factors.append(tuple(round_factor(T) for T in LU))
    sweeps = pc_opts.ilu_sweeps     # resolved by _build_dist
    if sweeps:
        st = _build_dist_ilu_neumann(factors, Pn, R, sweeps)
        if isinstance(st, _DistNeumannILUDyn):
            return "ilu_nmd", st.to(device)
        if st is not None:
            st = st.to(device)
            if pc_opts.transpose:
                st = dataclasses.replace(st, Lt=shard_transpose(st.L), Ut=shard_transpose(st.U))
            return "ilu_nm", st
        warnings.warn("distributed ILU: a single shard's factor exceeds the streaming "
                      "diagonal cap; falling back to exact level schedules (slow); "
                      "consider RCM ordering or more shards", RuntimeWarning, stacklevel=3)
    per = []
    for L, U in factors:
        scheds = (level_schedule(L, lower=True, device=device),
                  level_schedule(U, lower=False, device=device))
        if pc_opts.transpose:
            scheds += ilu_transpose_schedules(L, U, device=device)
        per.append(scheds)
    # each factor's strict nnz over the shards; Uᵀ and Lᵀ hold U's and L's
    nnz_l = sum(split_ldu(L)[0].nnz for L, _ in factors)
    nnz_u = sum(split_ldu(U)[2].nnz for _, U in factors)
    nnz = (nnz_l, nnz_u, nnz_u, nnz_l)
    return "ilu", tuple(_stack_or_list([sc[j] for sc in per], nnz[j], R)
                        for j in range(len(per[0])))


def _sweep_repeat(step, k: int, x0):
    """k applications of ``step``."""
    x = x0
    for _ in range(k):
        x = step(x)
    return x


def _dyn_index(offs: torch.Tensor, R: int):
    """Gather index and validity mask of a per-shard offset set: row i of
    slot k reads i + offs[p, k] when that lies in [0, R)."""
    src = torch.arange(R, device=offs.device) + offs[:, :, None]      # (P, nd, R)
    valid = (src >= 0) & (src < R)
    return src.clamp(0, R - 1).view(offs.shape[0], -1), valid


def _shard_pc_apply(kind, state, Pn: int, R: int, op=None, cycles: int = 1, mesh=None):
    """The preconditioner apply ``r ↦ M⁻¹r`` on the flat vector or on an
    (n, k) block (seen per shard as (P, R) or (P, R, k)), with its M⁻ᵀ as
    ``.t`` where it has one; each apply is the span ``lssp.pc.apply``.  An
    AMG apply runs ``cycles`` V-cycles over ``mesh``'s group, each after
    the first on the residual through the distributed operator ``op``."""
    fn = _shard_pc_fn(kind, state, Pn, R, op, cycles, mesh)

    def spanned(apply):
        def run(r):
            with annotate("lssp.pc.apply"):
                return apply(r)
        return run

    out = spanned(fn)
    if hasattr(fn, "t"):
        out.t = spanned(fn.t)
    return out


def _shard_pc_fn(kind, state, Pn: int, R: int, op, cycles: int, mesh):
    """``_shard_pc_apply``'s apply for each kind, without its span."""
    if kind == "none":
        def identity(r):
            return r
        identity.t = identity
        return identity
    if kind in ("amg", "saamg"):
        if kind == "amg":
            from lssp_tpu_torch.parallel.dist_amg import dist_vcycle as vcycle
        else:
            from lssp_tpu_torch.parallel.dist_sa import dist_sa_vcycle as vcycle

        def apply_mg(r):
            z = vcycle(state, r, mesh)
            for _ in range(cycles - 1):
                z = z + vcycle(state, r - op(z), mesh)
            return z
        return apply_mg

    def shards(r):
        return r.view(Pn, R, *r.shape[1:])

    def per_row(t, r):
        """A (P, R) state broadcast over a block's k columns."""
        return t[..., None] if r.ndim == 2 else t

    if kind == "jacobi":
        def jacobi(r):
            return (per_row(state, r) * shards(r)).view(r.shape)
        jacobi.t = jacobi                   # a diagonal scaling is symmetric
        return jacobi
    if kind == "ilu_nm":
        st = state

        def sweep(T, rhs):
            # y ← rhs − T·y, each shard's y zero-padded by its own halos:
            # block-Jacobi needs no exchange
            pad = (0, 0, T.lo, T.hi) if rhs.ndim == 3 else (T.lo, T.hi)
            return lambda y: _dia_local_spmv(T, F.pad(y, pad), -1.0, 1.0, rhs)

        def apply(T0, T1):
            def fn(r):
                r2 = shards(r)
                y = _sweep_repeat(sweep(T0, r2), st.sweeps, r2)
                zr = per_row(st.invdiag, r) * y
                return _sweep_repeat(sweep(T1, zr), st.sweeps, zr).view(r.shape)
            return fn

        fn = apply(st.L, st.U)
        if st.Ut is not None:
            # M⁻ᵀ: the same sweeps on the transposed bands, (D⁻¹Us)ᵀ first
            fn.t = apply(st.Ut, st.Lt)
        return fn
    if kind == "ilu_nmd":
        st = state
        iL, vL = _dyn_index(st.Loff, R)
        iU, vU = _dyn_index(st.Uoff, R)

        def stream(data, idx, valid, v):
            if v.ndim == 3:
                sh = v.gather(1, idx[..., None].expand(*idx.shape, v.shape[2]))
                sh = sh.view(*data.shape, v.shape[2])
                return (data[..., None] * torch.where(valid[..., None], sh, 0.0)).sum(dim=1)
            sh = v.gather(1, idx).view(data.shape)
            return (data * torch.where(valid, sh, 0.0)).sum(dim=1)

        def stream_t(data, idx, valid, v):
            # Σ_k data[k, j − off_k]·v[j − off_k]: each slot's products
            # shifted by its offset (JAX's ``_stream_dyn_t``)
            w = data[..., None] * v[:, None] if v.ndim == 3 else data * v[:, None]
            ix = idx.view(data.shape)
            if v.ndim == 3:
                sh = w.gather(2, ix[..., None].expand(*ix.shape, v.shape[2]))
                return torch.where(valid[..., None], sh, 0.0).sum(dim=1)
            return torch.where(valid, w.gather(2, ix), 0.0).sum(dim=1)

        def fn(r):
            r2 = shards(r)
            y = _sweep_repeat(lambda y: r2 - stream(st.Ldata, iL, vL, y), st.sweeps, r2)
            zr = per_row(st.invdiag, r) * y
            return _sweep_repeat(lambda z: zr - stream(st.Udata, iU, vU, z),
                                 st.sweeps, zr).view(r.shape)
        iLt, vLt = _dyn_index(-st.Loff, R)
        iUt, vUt = _dyn_index(-st.Uoff, R)

        def fn_t(r):
            r2 = shards(r)
            w = _sweep_repeat(lambda w: r2 - stream_t(st.Udata, iUt, vUt, w), st.sweeps, r2)
            zr = per_row(st.invdiag, r) * w
            return _sweep_repeat(lambda z: zr - stream_t(st.Ldata, iLt, vLt, z),
                                 st.sweeps, zr).view(r.shape)
        fn.t = fn_t
        return fn
    if kind == "ilu":
        # state: the schedules of L, U (and Uᵀ, Lᵀ), each stacked or a list
        def fn(r):
            return _sweep_shards(state[1], _sweep_shards(state[0], shards(r))).reshape(r.shape)
        if len(state) == 4:
            def fn_t(r):
                return _sweep_shards(state[3], _sweep_shards(state[2], shards(r))).reshape(r.shape)
            fn.t = fn_t
        return fn
    raise ValueError(kind)


def _grow_identity(A: CSR, extra: int) -> CSR:
    """A padded with ``extra`` decoupled identity rows and columns; the rhs
    and x0 get zero rows to match, which stay 0 through every Krylov
    recurrence."""
    import scipy.sparse as sp
    if extra == 0:
        return A
    return CSR.from_scipy(sp.bmat([[A.to_scipy(), None], [None, sp.eye(extra, format="csr")]],
                                  format="csr"))


def _dist_sizing(A: CSR, Pn: int, pc, pc_opts: PCOptions, fp):
    """(sa_grid, npad): the saamg grid dims and the identity rows to pad
    (``lssp_tpu/parallel/dist_solve.py: _dist_sizing``).  saamg on a grid
    whose gy divides by the shard count needs no padding, a flat plan pads
    to its P·gᴸ multiple (``planned_padded_size``); other PCs pad to a
    multiple of the shard count.  Memoized on the container against its
    fingerprint ``fp`` (the grid detection is an O(nnz) host scan)."""
    n = A.shape[0]
    if pc != "saamg":
        return False, (-n) % Pn
    key = ("dist-sizing", Pn, _pc_options_key(pc_opts))
    out = memo_get(A, "_prepared_cache", key, fp)
    if out is None:
        from lssp_tpu_torch.amg.aggregate import planned_padded_size
        from lssp_tpu_torch.amg.sa import detect_grid
        g0 = pc_opts.saamg_grid
        if g0 is None:
            g0 = detect_grid(A)
        elif g0 is False or g0[0] * g0[1] != n:
            g0 = None
        if g0 is not None and n % Pn == 0 and g0[0] % Pn == 0:
            out = (tuple(int(v) for v in g0), 0)
        else:
            out = (False, planned_padded_size(
                n, Pn, g=pc_opts.saamg_aggregate, coarse_size=pc_opts.amg_coarse_size,
                max_levels=pc_opts.amg_max_levels) - n)
        memo_put(A, "_prepared_cache", key, fp, out)
    return out


def _prepare_dist(A: CSR, mesh: Mesh, fmt, pc, pc_opts, ir, dtype, inner_dtype, sizing, fp):
    """The rhs-independent half of a distributed solve (identity padding,
    per-shard preconditioner, partition in one or, for ``ir``, two
    precisions, upload), memoized on the container in ``A._dist_cache``
    against its content fingerprint ``fp`` (``utils.memo``), LRU-bounded
    to 8 entries: each pins device copies of the partitioned matrix and
    the preconditioner state."""
    key = (mesh, fmt, pc, _pc_options_key(pc_opts), ir, str(dtype), str(inner_dtype), sizing)
    out = memo_get(A, "_dist_cache", key, fp)
    if out is None:
        out = _build_dist(A, mesh, fmt, pc, pc_opts, ir, dtype, inner_dtype, *sizing)
        memo_put(A, "_dist_cache", key, fp, out, bound=8)
    return out


def _local_state(kind, state, p0: int, p1: int):
    """A preconditioner state cut to the shards [p0, p1) (every tensor of it
    has the leading shard axis, but an AMG hierarchy's coarse inverse and
    interface inverses, which stay whole)."""
    def cut(t):
        return t[p0:p1]
    if kind in ("amg", "saamg"):
        return state.local(p0, p1)
    if kind == "ilu_nm":
        bands = {f: getattr(state, f).local(p0, p1) for f in ("L", "U", "Lt", "Ut")
                 if getattr(state, f) is not None}
        return dataclasses.replace(state, invdiag=cut(state.invdiag), **bands)
    if kind == "ilu":
        return tuple(S[p0:p1] if isinstance(S, list) else map_tensors(cut, S) for S in state)
    return map_tensors(cut, state)


def _build_dist(A: CSR, mesh: Mesh, fmt, pc, pc_opts, ir, dtype, inner_dtype, sa_grid, npad):
    A = _grow_identity(A, npad)
    Pn, device = mesh.size, mesh.device
    n = A.shape[0]
    R = n // Pn
    # ir: the preconditioner and the inner operator live in the inner dtype;
    # a bfloat16 one is built in float32 from A rounded to bf16, its factors
    # rounded to bf16 (pc.base.rounding_to) and its state cast on the device
    wdtype = inner_dtype if ir else dtype
    work = round_to(A, wdtype)
    # every rank builds the whole state on the host, the same decisions from
    # the same data (the Neumann sweeps are the device's default; an AMG
    # hierarchy's grid or flat plan, its fallbacks and its padding), and
    # uploads its own shards
    if pc_opts.ilu_sweeps is None:
        pc_opts = dataclasses.replace(pc_opts, ilu_sweeps=default_ilu_sweeps(device))
    with rounding_to(wdtype):
        kind, pc_state = _build_dist_pc(work, pc, pc_opts, Pn, R, torch.device("cpu"), sa_grid)
    if kind == "saamg" and pc_state.n_top != n:
        # grid coarsening stalled and the hierarchy took the flat plan, which
        # pads itself: grow the system to the hierarchy's size
        A = _grow_identity(A, pc_state.n_top - n)
        n = A.shape[0]
        R = n // Pn
        work = round_to(A, wdtype)
    if wdtype == torch.bfloat16:
        pc_state = cast_state(pc_state, wdtype)
    p0, p1 = mesh.rank * mesh.slots, (mesh.rank + 1) * mesh.slots
    M = partition_matrix(work, Pn, fmt=fmt).local(p0, p1).to(device, dtype=wdtype)
    M64 = (partition_matrix(A.astype(np.float64), Pn, fmt=fmt).local(p0, p1).to(device)
           if ir else None)
    pc_state = map_tensors(lambda t: t.to(device), _local_state(kind, pc_state, p0, p1))
    return dict(n=n, R=R, M=M, M64=M64, kind=kind, pc_state=pc_state)


def _dist_launch(A, b, x0, method: str, pc, mesh, options, pc_options, fmt: str,
                 ir: bool = False, inner_rtol: float = 1e-3, max_outer: int = 20,
                 inner_dtype=torch.float32, multi: bool = False):
    """The one distributed launcher behind ``dist_solve``, ``dist_solve_ir``
    and their multi-rhs forms (``multi``: b is an (n, k) block): checks
    the input, pads the system to a multiple of the shard count, fetches
    the prepared state and runs the solve."""
    opts = (options or SolverOptions()).resolved()
    pc_opts = (pc_options or PCOptions()).resolved()
    if isinstance(A, COO):
        A = coo_to_csr(A)
    if not isinstance(A, CSR):
        raise TypeError(f"the distributed solve takes a host CSR or COO, got {type(A)}")
    b = check_input(A, b, method, "dist_solve_ir_multi" if ir else "dist_solve_multi", multi)
    fn, solver_opts = (_inner_plan(method, opts, inner_rtol, multi=multi) if ir
                       else (solver_for(method, multi), opts))
    if needs_transpose_pc(method):
        if pc not in TRANSPOSE_PCS:
            raise ValueError(f"distributed {method} supports pc in (none, jacobi, bjilu/ilu*): "
                             f"{pc!r} has no distributed transpose apply")
        pc_opts = dataclasses.replace(pc_opts, transpose=True)
    mesh = mesh or make_mesh()
    Pn, device = mesh.size, mesh.device
    pdot = make_psum_dot(mesh.slots, mesh)
    if get_block_solver(method) is None:
        # every inner product of the method is a psum over the shards
        fn = functools.partial(fn, dot=pdot)
    elif mesh.group is not None:
        # every Gram of a block method is summed over the ranks (JAX's reduce=)
        fn = functools.partial(fn, reduce=functools.partial(rank_sum, mesh=mesh))
    dtype = torch.float64 if ir else torch.promote_types(torch_dtype(A.dtype), b.dtype)
    n_orig = A.shape[0]
    b, x0 = place_system(A.shape, b, x0, dtype, device)
    fp = fingerprint(A)         # one content scan for both memo lookups
    prep = _prepare_dist(A, mesh, fmt, pc, pc_opts, ir, dtype, inner_dtype,
                         _dist_sizing(A, Pn, pc, pc_opts, fp), fp)
    n, R = prep["n"], prep["R"]
    if n > n_orig:
        pad = (n - n_orig,) + tuple(b.shape[1:])
        b = torch.cat([b, b.new_zeros(pad)])
        x0 = torch.cat([x0, x0.new_zeros(pad)])
    # this rank's rows (all of them on one rank)
    rows = slice(mesh.rank * mesh.slots * R, (mesh.rank + 1) * mesh.slots * R)
    b, x0 = b[rows], x0[rows]
    op = make_dist_spmv(prep["M"], mesh)
    if needs_transpose_pc(method):
        op = OpWithTranspose(op, make_dist_spmv_t(prep["M"], mesh))
    pc_apply = _shard_pc_apply(prep["kind"], prep["pc_state"], mesh.slots, R, op=op,
                               cycles=max(1, int(pc_opts.amg_cycles)), mesh=mesh)
    if ir:
        def inner(r32):
            return fn(op, r32, torch.zeros_like(r32), pc_apply, opts=solver_opts)

        # refine's default verbosity: the mesh's single-rhs rounds log nothing
        x, info = (refine_multi if multi else refine)(
            make_dist_spmv(prep["M64"], mesh), inner, b, x0, opts, max_outer, inner_dtype,
            functools.partial(norm, dot_fn=pdot))
    else:
        x, info = fn(op, b, x0, pc_apply, opts=solver_opts)
    if mesh.world > 1:
        x = gather_rows(x, mesh)
    return x[:n_orig], info


def dist_solve(A, b, x0=None, method: str = "cg", pc: Optional[str] = "none",
               mesh: Optional[Mesh] = None, options: Optional[SolverOptions] = None,
               pc_options: Optional[PCOptions] = None, fmt: str = "auto"):
    """Ax = b over a shard mesh.  Returns (x (n,) on the mesh's device,
    SolveInfo).

    ``fmt`` picks the distributed format: "auto" tries DIA, then HYB, then
    padded ELL (halo, else all-gather); "dia", "hyb", "ell", "halo" and
    "allgather" force one.  ``n`` need not divide the shard count: rows
    are padded with identity equations (zero rhs).  ``pc``: "none",
    "jacobi", block-Jacobi "bjilu" (ILU(k) at ``iluk_level``), "iluk",
    "ilu0", "ilut", or the distributed AMG hierarchies "saamg", "rsamg"
    and "amg" (a saamg plan may pad the system further).  The call is the
    span ``lssp.dist_solve``."""
    with annotate("lssp.dist_solve"):
        return _dist_launch(A, b, x0, method, pc, mesh, options, pc_options, fmt)


def dist_solve_multi(A, B, X0=None, method: str = "cg", pc: Optional[str] = "none",
                     mesh: Optional[Mesh] = None, options: Optional[SolverOptions] = None,
                     pc_options: Optional[PCOptions] = None, fmt: str = "auto"):
    """A·X = B over a shard mesh for k right-hand sides (B: (n, k)), the
    sharded ``solve_multi``: a block method shares one search block with
    every Gram reduced per shard, then over the shards; any other method
    runs column by column in one batched loop.  Every DIA product and
    Neumann sweep is one K4k launch for all shards and columns.  Returns
    (X (n, k), SolveInfo with (k,) fields).  Other arguments as in
    ``dist_solve``; the call is the span ``lssp.dist_solve_multi``."""
    with annotate("lssp.dist_solve_multi"):
        return _dist_launch(A, B, X0, method, pc, mesh, options, pc_options, fmt, multi=True)


def dist_solve_ir(A, b, x0=None, method: str = "gmres", pc: Optional[str] = "none",
                  mesh: Optional[Mesh] = None, options: Optional[SolverOptions] = None,
                  pc_options: Optional[PCOptions] = None, fmt: str = "auto",
                  inner_rtol: float = 1e-3, max_outer: int = 20, inner_dtype=torch.float32):
    """Mixed-precision refinement over a shard mesh: fp64 x, the Krylov
    loop, the preconditioner and its factors in ``inner_dtype``.  Same
    inner policy as ``solve_ir``; ``nits`` counts the inner iterations.  The
    call is the span ``lssp.dist_solve_ir``."""
    with annotate("lssp.dist_solve_ir"):
        return _dist_launch(A, b, x0, method, pc, mesh, options, pc_options, fmt, ir=True,
                            inner_rtol=inner_rtol, max_outer=max_outer,
                            inner_dtype=inner_dtype)


def dist_solve_ir_multi(A, B, X0=None, method: str = "blockgmres", pc: Optional[str] = "none",
                        mesh: Optional[Mesh] = None, options: Optional[SolverOptions] = None,
                        pc_options: Optional[PCOptions] = None, fmt: str = "auto",
                        inner_rtol: float = 1e-3, max_outer: int = 20,
                        inner_dtype=torch.float32):
    """Mixed-precision refinement over a shard mesh for k right-hand sides
    (B: (n, k)), the sharded ``solve_ir_multi``: fp64 residuals per column,
    one ``inner_dtype`` inner solve per round for the whole block (block
    GMRES by default), converged columns frozen.  Returns (X fp64 (n, k),
    SolveInfo with (k,) fields counting each column's inner iterations).
    The call is the span ``lssp.dist_solve_ir_multi``."""
    with annotate("lssp.dist_solve_ir_multi"):
        return _dist_launch(A, B, X0, method, pc, mesh, options, pc_options, fmt, ir=True,
                            inner_rtol=inner_rtol, max_outer=max_outer,
                            inner_dtype=inner_dtype, multi=True)
