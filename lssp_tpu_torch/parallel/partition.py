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

from lssp_tpu_torch.sparse.convert import csr_entry_offsets, csr_to_hyb
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


def partition_csr_dia(A: CSR, nshards: int, max_diags: int = 256,
                      dia_fill: float = 50.0) -> DistDIA:
    """Partition a banded matrix into per-shard DIA blocks.  Raises
    ``ValueError`` when it has too many distinct diagonals, too much padding
    waste, or a band that reaches past one neighbouring shard."""
    R = _shard_rows(A, nshards)
    n = A.shape[0]
    rows, d, offs = csr_entry_offsets(A.indptr, A.indices, n)
    if len(offs) > max_diags:
        raise ValueError(f"{len(offs)} diagonals > max_diags={max_diags}")
    if len(offs) * n > dia_fill * max(A.nnz, 1):
        raise ValueError("DIA padding waste too large")
    _check_reach(max(0, -int(offs.min(initial=0))), max(0, int(offs.max(initial=0))), R)
    data = np.zeros((len(offs), n), dtype=np.asarray(A.data).dtype)
    data[np.searchsorted(offs, d), rows] = np.asarray(A.data)
    return _stack_band(data, offs, n, nshards)


def partition_csr_hyb(A: CSR, nshards: int, max_diags: int = 256,
                      min_occ: float = 0.02, min_cover: float = 0.5,
                      pad_to: int = 8) -> DistHYB:
    """Partition a nearly-banded matrix: ``csr_to_hyb``'s band as a DistDIA,
    its nonzero remainder entries grouped by owning shard.  Raises
    ``ValueError`` when no dominant band exists or the band reaches past one
    neighbouring shard."""
    R = _shard_rows(A, nshards)
    n = A.shape[0]
    H = csr_to_hyb(A, max_diags=max_diags, min_occ=min_occ, min_cover=min_cover)
    offs = H.dia.offsets
    _check_reach(max(0, -min(offs)) if offs else 0, max(0, max(offs)) if offs else 0, R)
    band = _stack_band(H.dia.data.numpy(), offs, n, nshards)
    rr = H.rem_rows.numpy().astype(np.int64)
    rc = H.rem_cols.numpy().astype(np.int64)
    rv = H.rem_vals.numpy()
    real = rv != 0
    rr, rc, rv = rr[real], rc[real], rv[real]
    shard = rr // R
    counts = np.bincount(shard, minlength=nshards)
    nrem = _round_up(max(int(counts.max()), 1), pad_to)
    rows_p = np.zeros((nshards, nrem), dtype=np.int64)
    cols_p = np.zeros((nshards, nrem), dtype=np.int64)
    vals_p = np.zeros((nshards, nrem), dtype=rv.dtype)
    # the triplets are row-sorted, so each shard's run is contiguous
    slot = np.arange(len(rr), dtype=np.int64) - np.concatenate([[0], np.cumsum(counts)])[shard]
    rows_p[shard, slot] = rr - shard * R
    cols_p[shard, slot] = rc
    vals_p[shard, slot] = rv
    return DistHYB(band, _t(rows_p), _t(cols_p), _t(vals_p))


def partition_csr(A: CSR, nshards: int, mode: str = "auto", pad_to: int = 4) -> DistELL:
    """Partition rows into padded ELL blocks.  mode "auto": halo layout when
    every off-shard column lies within one neighbouring shard and reaches
    at most R into it, else all-gather."""
    R = _shard_rows(A, nshards)
    n = A.shape[0]
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    shard_of_row = rows // R
    if mode in ("auto", "halo"):
        d = idx // R - shard_of_row
        if np.abs(d).max(initial=0) <= 1:
            lo_reach = np.where(d == -1, shard_of_row * R - idx, 0).max(initial=0)
            hi_reach = np.where(d == 1, idx - ((shard_of_row + 1) * R - 1), 0).max(initial=0)
            h = int(max(lo_reach, hi_reach))
            if h <= R:
                return _build(A, nshards, R, h, "halo", pad_to)
        if mode == "halo":
            raise ValueError("matrix is not banded enough for halo mode")
    return _build(A, nshards, R, 0, "allgather", pad_to)


def _build(A: CSR, P: int, R: int, h: int, mode: str, pad_to: int) -> DistELL:
    n = A.shape[0]
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    rn = ip[1:] - ip[:-1]
    k = max(1, _round_up(int(rn.max()), pad_to))
    pos = np.arange(k)[None, :] < rn[:, None]            # (n, k) valid slots
    flat = (ip[:-1][:, None] + np.arange(k)[None, :])[pos]
    cols = np.zeros((n, k), dtype=np.int64)
    data = np.zeros((n, k), dtype=dat.dtype)
    cols[pos] = idx[flat]
    data[pos] = dat[flat]
    if mode == "halo":
        # into the row's extended frame [0, R + 2h); padded slots stay at 0
        shard_of_row = np.arange(n, dtype=np.int64) // R
        cols[pos] = (cols - (shard_of_row * R)[:, None] + h)[pos]
    return DistELL(_t(cols.reshape(P, R, k)), _t(data.reshape(P, R, k)), n, P, h, mode)


def partition_matrix(A: CSR, nshards: int, fmt: str = "auto"):
    """The distributed execution format: DIA when the matrix is banded,
    band plus remainder when nearly banded, padded ELL (halo, else
    all-gather) otherwise.  ``fmt`` forces one: "dia", "hyb", "ell",
    "halo" or "allgather"."""
    if fmt in ("auto", "dia"):
        try:
            return partition_csr_dia(A, nshards)
        except ValueError:
            if fmt == "dia":
                raise
    if fmt in ("auto", "hyb"):
        try:
            return partition_csr_hyb(A, nshards)
        except ValueError:
            if fmt == "hyb":
                raise
    if fmt in ("auto", "ell", "halo", "allgather"):
        mode = fmt if fmt in ("halo", "allgather") else "auto"
        return partition_csr(A, nshards, mode=mode)
    raise ValueError(f"unknown distributed format {fmt!r}")


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
