"""Host-side row partitioning for the distributed solve.

A CSR matrix is split into P equal row blocks, and each container keeps a
leading shard axis on every array: ``DistDIA.data`` is (P, ndiag, R),
``DistHYB``'s remainder (P, nrem), ``DistELL``'s arrays (P, R, k).  The
host work is numpy and gives the same arrays as
``lssp_tpu/parallel/partition.py``; the containers hold them as tensors
and move with ``.to(device)``.  Index arrays are int64 here (torch's
index type); JAX stores them as int32.  ``.local(p0, p1)`` is a rank's
slice, the shards [p0, p1) with the partition's halo widths and offsets:
its ``n`` and ``nshards`` count the rank's rows and shards, while a HYB
remainder's and an all-gather ELL's columns stay global.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import numpy as np
import torch

from lssp_tpu_torch.sparse.convert import BandCoverageError, _select_band
from lssp_tpu_torch.sparse.types import CSR


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass(frozen=True)
class DistDIA:
    """Row-partitioned DIA: ``data[p, d, r] = A[p·R + r, p·R + r +
    offsets[d]]``.  Shard p's product streams over ``x_ext = [halo_lo(lo)
    | x_p(R) | halo_hi(hi)]``.  Out-of-range diagonal slots store 0, so no
    edge masking is needed: the ring wrap-around values in shard 0's left
    halo and shard P−1's right halo are always multiplied by a stored 0.
    ``offsets_t`` is the offsets as an int32 tensor on ``data``'s device,
    built once for kernel K4."""

    data: Any                  # (P, ndiag, R) tensor
    offsets: Tuple[int, ...]   # sorted
    n: int                     # global rows
    nshards: int               # P

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.nshards

    @property
    def lo(self) -> int:
        return max(0, -min(self.offsets)) if self.offsets else 0

    @property
    def hi(self) -> int:
        return max(0, max(self.offsets)) if self.offsets else 0

    @functools.cached_property
    def offsets_t(self) -> torch.Tensor:
        return torch.tensor(self.offsets, dtype=torch.int32, device=self.data.device)

    def to(self, device=None, dtype=None) -> "DistDIA":
        return dataclasses.replace(self, data=self.data.to(device=device, dtype=dtype))

    def local(self, p0: int, p1: int) -> "DistDIA":
        return DistDIA(self.data[p0:p1], self.offsets, (p1 - p0) * self.rows_per_shard, p1 - p0)


@dataclasses.dataclass(frozen=True)
class DistHYB:
    """Row-partitioned band plus remainder: the band as a ``DistDIA`` (halo
    exchange), the other entries as per-shard COO triplets with LOCAL row
    and GLOBAL column indices, applied against the whole x.  Each shard's
    triplets are zero-padded with (0, 0, 0.0) to a common length, a
    multiple of 8."""

    band: DistDIA
    rem_rows: Any              # (P, nrem) int64, local row ids
    rem_cols: Any              # (P, nrem) int64, global col ids
    rem_vals: Any              # (P, nrem)

    @property
    def n(self) -> int:
        return self.band.n

    @property
    def nshards(self) -> int:
        return self.band.nshards

    @property
    def rows_per_shard(self) -> int:
        return self.band.rows_per_shard

    def to(self, device=None, dtype=None) -> "DistHYB":
        return DistHYB(self.band.to(device, dtype), self.rem_rows.to(device),
                       self.rem_cols.to(device),
                       self.rem_vals.to(device=device, dtype=dtype))

    def local(self, p0: int, p1: int) -> "DistHYB":
        return DistHYB(self.band.local(p0, p1), self.rem_rows[p0:p1], self.rem_cols[p0:p1],
                       self.rem_vals[p0:p1])


@dataclasses.dataclass(frozen=True)
class DistELL:
    """Row-partitioned padded ELL.  mode "halo": ``cols`` index shard p's
    ``[halo_left(h) | x_p(R) | halo_right(h)]``; mode "allgather": ``cols``
    are global and the product reads the whole x."""

    cols: Any                  # (P, R, k) int64
    data: Any                  # (P, R, k)
    n: int
    nshards: int
    halo: int                  # h; 0 in allgather mode
    mode: str                  # "halo" | "allgather"

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.nshards

    def to(self, device=None, dtype=None) -> "DistELL":
        return dataclasses.replace(self, cols=self.cols.to(device),
                                   data=self.data.to(device=device, dtype=dtype))

    def local(self, p0: int, p1: int) -> "DistELL":
        return dataclasses.replace(self, cols=self.cols[p0:p1], data=self.data[p0:p1],
                                   n=(p1 - p0) * self.rows_per_shard, nshards=p1 - p0)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _shard_rows(A: CSR, nshards: int) -> int:
    n, m = A.shape
    if n != m:
        raise ValueError("only square matrices supported")
    if n % nshards:
        raise ValueError(f"n={n} not divisible by nshards={nshards}")
    return n // nshards


def _check_reach(lo: int, hi: int, R: int) -> None:
    if lo > R or hi > R:
        raise ValueError(f"band reach ({lo},{hi}) exceeds shard size R={R}: halo would "
                         "span more than one neighbour")


def _stack_band(data: np.ndarray, offsets, n: int, nshards: int) -> DistDIA:
    """(ndiag, n) row-aligned band → (P, ndiag, R): shard p takes columns
    [p·R, (p+1)·R)."""
    R = n // nshards
    data = np.swapaxes(data.reshape(len(offsets), nshards, R), 0, 1)
    return DistDIA(_t(data), tuple(int(o) for o in offsets), n, nshards)


def row_block(A: CSR, r0: int, r1: int) -> CSR:
    """Rows [r0, r1) of A with every column: an (r1 − r0, m) CSR whose
    indices and values are views of A's."""
    ip = np.asarray(A.indptr).astype(np.int64)
    a, b = int(ip[r0]), int(ip[r1])
    return CSR(ip[r0:r1 + 1] - a, np.asarray(A.indices)[a:b], np.asarray(A.data)[a:b],
               (r1 - r0, A.shape[1]))


# ---------------------------------------------------------------------------
# A partition is made in three steps, so that a rank can make its own
# shards alone: each shard's statistics (``shard_stats``, from its rows),
# the choices every shard shares (``plan_partition``, from every shard's
# statistics: the format, the band's offsets, the halo widths, the padded
# widths), and each shard's arrays (``partition_rows``, from its rows and
# the plan).  The whole matrix is the case of every shard at once.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardStats:
    """What a partition's choices read of one shard's rows: its entries'
    diagonal offsets (col − row), sorted, with their counts and, for each
    value array, the count of nonzero values on each (a HYB remainder
    drops stored zeros); its longest row; and how far its columns reach:
    the most shards away (``reach``) and, into the shards on either side,
    the most rows past its edge (``lo_reach``, ``hi_reach``)."""

    offsets: np.ndarray
    counts: np.ndarray
    nonzero: tuple
    row_max: int
    reach: int
    lo_reach: int
    hi_reach: int


def _offset_counts(d: np.ndarray, weights):
    """The sorted distinct values of ``d``, the count of each and each
    weight array's sum on each: by a counting pass while their range is
    narrow (a band), else by a sort."""
    if not len(d):
        empty = np.zeros(0, np.int64)
        return empty, empty, [empty for _ in weights]
    lo = int(d.min())
    width = int(d.max()) - lo + 1
    if width <= 4 * len(d):
        key, values = d - lo, np.arange(lo, lo + width, dtype=np.int64)
    else:
        values, key = np.unique(d, return_inverse=True)
    counts = np.bincount(key, minlength=len(values))
    present = np.flatnonzero(counts)
    sums = [np.bincount(key, weights=w, minlength=len(values))[present].astype(np.int64)
            for w in weights]
    return values[present], counts[present], sums


def shard_stats(A: CSR, R: int, p0: int, p1: int, values=None) -> list:
    """The ``ShardStats`` of each shard p in [p0, p1) of a matrix whose
    rows ``A`` holds from global row p0·R on, every column global (the
    whole matrix for p0 = 0 and p1 = P).  ``values``: the value arrays, in
    A's layout, whose nonzero entries are counted (A's own by default)."""
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices)
    vals = [np.asarray(A.data)] if values is None else [np.asarray(v) for v in values]
    out = []
    for q, p in enumerate(range(p0, p1)):
        a, b = int(ip[q * R]), int(ip[(q + 1) * R])
        rn = np.diff(ip[q * R:(q + 1) * R + 1])
        cols = idx[a:b].astype(np.int64)
        d = cols - np.repeat(np.arange(p * R, (p + 1) * R, dtype=np.int64), rn)
        offsets, counts, nonzero = _offset_counts(d, [v[a:b] != 0 for v in vals])
        s = cols // R - p
        out.append(ShardStats(
            offsets=offsets, counts=counts, nonzero=tuple(nonzero),
            row_max=int(rn.max(initial=0)), reach=int(np.abs(s).max(initial=0)),
            lo_reach=int(np.where(s == -1, p * R - cols, 0).max(initial=0)),
            hi_reach=int(np.where(s == 1, cols - ((p + 1) * R - 1), 0).max(initial=0))))
    return out


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """The choices every shard of a partition shares: the format ("dia",
    "hyb" or "ell"); the band's offsets (DIA, and the band of a HYB); a
    HYB's remainder slots a shard, one count for each value array the
    statistics counted; an ELL's padded width, halo and mode ("halo" or
    "allgather")."""

    fmt: str
    offsets: Tuple[int, ...] = ()
    nrem: Tuple[int, ...] = ()
    width: int = 0
    halo: int = 0
    mode: str = ""


def _union(stats):
    """The sorted union of the shards' offsets and each one's count over
    every shard."""
    offs = np.unique(np.concatenate([s.offsets for s in stats] + [np.zeros(0, np.int64)]))
    counts = np.zeros(len(offs), np.int64)
    for s in stats:
        counts[np.searchsorted(offs, s.offsets)] += s.counts
    return offs, counts


def _dia_plan(stats, n: int, nnz: int, R: int, max_diags: int = 256,
              dia_fill: float = 50.0) -> PartitionPlan:
    """Every diagonal as a band.  Raises ``ValueError`` on too many
    distinct diagonals, too much padding waste, or a band that reaches past
    one neighbouring shard."""
    offs, _ = _union(stats)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} diagonals > max_diags={max_diags}")
    if len(offs) * n > dia_fill * max(nnz, 1):
        raise ValueError("DIA padding waste too large")
    _check_reach(max(0, -int(offs.min(initial=0))), max(0, int(offs.max(initial=0))), R)
    return PartitionPlan("dia", offsets=tuple(int(o) for o in offs))


def _hyb_plan(stats, n: int, nnz: int, R: int, max_diags: int = 256, min_occ: float = 0.02,
              min_cover: float = 0.5, pad_to: int = 8) -> PartitionPlan:
    """``csr_to_hyb``'s band (``_select_band`` on the diagonals' counts over
    every shard), the other entries per shard, padded to a common multiple
    of ``pad_to``.  Raises ``ValueError`` when no dominant band exists, the
    remainder passes int32 or the band reaches past one neighbouring
    shard."""
    offs, counts = _union(stats)
    take = _select_band(counts, n, max_diags, min_occ)
    if len(take) == 0 or counts[take].sum() < min_cover * max(nnz, 1):
        raise BandCoverageError(f"band coverage {counts[take].sum() / max(nnz, 1):.2f} below "
                                f"min_cover={min_cover}; use ELL")
    if max(n, nnz - int(counts[take].sum())) >= 2**31:
        raise ValueError("HYB indexes rows, columns and remainder entries in int32")
    kept = np.sort(offs[take])
    _check_reach(max(0, -int(kept[0])), max(0, int(kept[-1])), R)
    # a shard's remainder: its entries off the band whose value is not 0
    off_band = [~np.isin(s.offsets, kept) for s in stats]
    nrem = tuple(_round_up(max(max(int(s.nonzero[j][m].sum()) for s, m in zip(stats, off_band)),
                               1), pad_to)
                 for j in range(len(stats[0].nonzero)))
    return PartitionPlan("hyb", offsets=tuple(int(o) for o in kept), nrem=nrem)


def _ell_plan(stats, R: int, mode: str = "auto", pad_to: int = 4) -> PartitionPlan:
    """Padded ELL: mode "auto" takes the halo layout when every off-shard
    column lies within one neighbouring shard and reaches at most R into
    it, else all-gather."""
    width = max(1, _round_up(max(s.row_max for s in stats), pad_to))
    if mode in ("auto", "halo"):
        if max(s.reach for s in stats) <= 1:
            h = max(max(s.lo_reach, s.hi_reach) for s in stats)
            if h <= R:
                return PartitionPlan("ell", width=width, halo=h, mode="halo")
        if mode == "halo":
            raise ValueError("matrix is not banded enough for halo mode")
    return PartitionPlan("ell", width=width, halo=0, mode="allgather")


def plan_partition(stats, n: int, nnz: int, fmt: str = "auto") -> PartitionPlan:
    """The plan of ``partition_matrix`` from every shard's ``ShardStats``,
    in global shard order, of an n-row matrix of ``nnz`` entries: DIA when
    it is banded, band plus remainder when nearly banded, padded ELL (halo,
    else all-gather) otherwise; ``fmt`` forces one."""
    R = n // len(stats)
    if fmt in ("auto", "dia"):
        try:
            return _dia_plan(stats, n, nnz, R)
        except ValueError:
            if fmt == "dia":
                raise
    if fmt in ("auto", "hyb"):
        try:
            return _hyb_plan(stats, n, nnz, R)
        except ValueError:
            if fmt == "hyb":
                raise
    if fmt in ("auto", "ell", "halo", "allgather"):
        return _ell_plan(stats, R, mode=fmt if fmt in ("halo", "allgather") else "auto")
    raise ValueError(f"unknown distributed format {fmt!r}")


def partition_rows(A: CSR, plan: PartitionPlan, R: int, p0: int, p1: int, values: int = 0):
    """The shards [p0, p1) of the partition ``plan`` chose, from their rows
    ``A`` (as ``shard_stats`` takes them): a ``DistDIA``, ``DistHYB`` or
    ``DistELL`` of p1 − p0 shards, the arrays of ``.local(p0, p1)`` of the
    whole partition.  ``values``: which of the statistics' value arrays
    ``A``'s values are (a HYB remainder's slots)."""
    P, row0 = p1 - p0, p0 * R
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    rn = np.diff(ip)
    if plan.fmt == "ell":
        return _build_ell(ip, idx, dat, rn, P, R, row0, plan)
    rows = np.repeat(np.arange(row0, row0 + P * R, dtype=np.int64), rn)
    d = idx - rows
    offs = np.asarray(plan.offsets, dtype=np.int64)
    in_band = np.isin(d, offs) if plan.fmt == "hyb" else slice(None)
    band = np.zeros((len(offs), P * R), dtype=dat.dtype)
    band[np.searchsorted(offs, d[in_band]), rows[in_band] - row0] = dat[in_band]
    band = _stack_band(band, plan.offsets, P * R, P)
    if plan.fmt == "dia":
        return band
    out = ~in_band
    real = dat[out] != 0
    rr, rc, rv = rows[out][real], idx[out][real], dat[out][real]
    shard = rr // R - p0
    counts = np.bincount(shard, minlength=P)
    nrem = plan.nrem[values]
    rows_p = np.zeros((P, nrem), dtype=np.int64)
    cols_p = np.zeros((P, nrem), dtype=np.int64)
    vals_p = np.zeros((P, nrem), dtype=rv.dtype)
    # the triplets are row-sorted, so each shard's run is contiguous
    slot = np.arange(len(rr), dtype=np.int64) - np.concatenate([[0], np.cumsum(counts)])[shard]
    rows_p[shard, slot] = rr - (shard + p0) * R
    cols_p[shard, slot] = rc
    vals_p[shard, slot] = rv
    return DistHYB(band, _t(rows_p), _t(cols_p), _t(vals_p))


def _build_ell(ip, idx, dat, rn, P: int, R: int, row0: int, plan: PartitionPlan) -> DistELL:
    k = plan.width
    pos = np.arange(k)[None, :] < rn[:, None]            # (rows, k) valid slots
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[pos]
    cols = np.zeros((P * R, k), dtype=np.int64)
    data = np.zeros((P * R, k), dtype=dat.dtype)
    cols[pos] = idx[flat]
    data[pos] = dat[flat]
    if plan.mode == "halo":
        # into the row's extended frame [0, R + 2h); padded slots stay at 0
        shard_of_row = (row0 + np.arange(P * R, dtype=np.int64)) // R
        cols[pos] = (cols - (shard_of_row * R)[:, None] + plan.halo)[pos]
    return DistELL(_t(cols.reshape(P, R, k)), _t(data.reshape(P, R, k)), P * R, P, plan.halo,
                   plan.mode)


def _whole(A: CSR, nshards: int, plan_of):
    """Every shard of A at once, ``plan_of(stats, n, nnz, R)`` choosing."""
    R = _shard_rows(A, nshards)
    plan = plan_of(shard_stats(A, R, 0, nshards), A.shape[0], A.nnz, R)
    return partition_rows(A, plan, R, 0, nshards)


def partition_csr_dia(A: CSR, nshards: int, max_diags: int = 256,
                      dia_fill: float = 50.0) -> DistDIA:
    """Partition a banded matrix into per-shard DIA blocks.  Raises
    ``ValueError`` when it has too many distinct diagonals, too much padding
    waste, or a band that reaches past one neighbouring shard."""
    return _whole(A, nshards, lambda s, n, nnz, R: _dia_plan(s, n, nnz, R, max_diags, dia_fill))


def partition_csr_hyb(A: CSR, nshards: int, max_diags: int = 256,
                      min_occ: float = 0.02, min_cover: float = 0.5,
                      pad_to: int = 8) -> DistHYB:
    """Partition a nearly-banded matrix: ``csr_to_hyb``'s band as a DistDIA,
    its nonzero remainder entries grouped by owning shard.  Raises
    ``ValueError`` when no dominant band exists or the band reaches past one
    neighbouring shard."""
    return _whole(A, nshards, lambda s, n, nnz, R: _hyb_plan(s, n, nnz, R, max_diags, min_occ,
                                                             min_cover, pad_to))


def partition_csr(A: CSR, nshards: int, mode: str = "auto", pad_to: int = 4) -> DistELL:
    """Partition rows into padded ELL blocks.  mode "auto": halo layout when
    every off-shard column lies within one neighbouring shard and reaches
    at most R into it, else all-gather."""
    return _whole(A, nshards, lambda s, n, nnz, R: _ell_plan(s, R, mode, pad_to))


def partition_matrix(A: CSR, nshards: int, fmt: str = "auto"):
    """The distributed execution format: DIA when the matrix is banded,
    band plus remainder when nearly banded, padded ELL (halo, else
    all-gather) otherwise.  ``fmt`` forces one: "dia", "hyb", "ell",
    "halo" or "allgather"."""
    return _whole(A, nshards, lambda s, n, nnz, R: plan_partition(s, n, nnz, fmt))


def shard_vector(x, nshards: int, mesh=None) -> torch.Tensor:
    """(n,) → the (P, R) shard view; over the ranks of ``mesh`` (``nshards``
    global) this rank's (P_loc, R) rows."""
    xs = torch.as_tensor(x).reshape(nshards, -1)
    if mesh is None:
        return xs
    return xs[mesh.rank * mesh.slots:(mesh.rank + 1) * mesh.slots]


def unshard_vector(xs, mesh=None) -> torch.Tensor:
    """(P, R) → (n,); over the ranks of ``mesh`` every rank's (P_loc, R)
    rows all-gathered, so that every rank returns the whole vector."""
    from lssp_tpu_torch.parallel.dist_ops import gather_rows
    return gather_rows(torch.as_tensor(xs).reshape(-1), mesh)
