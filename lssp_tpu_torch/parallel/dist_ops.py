"""Distributed products and reductions on a shard mesh held on one device.

The JAX package runs these per shard under ``shard_map``: the halo exchange
is two ring ``ppermute`` shifts and a dot is a local sum plus ``psum``.
Here the P shards are the leading axis of one tensor, so a ``ppermute`` is
a shift along that axis (``torch.roll``), an ``all_gather`` is the flat
vector itself, and a ``psum`` is a sum over the shard axis.  Every operator
takes and returns the flat (n,) vector, or an (n, k) block (the layout of
``ops/spmv.py``, viewed as (P, R, k)); shard p owns rows [p·R, (p+1)·R).
A DIA band's block product is kernel K4k, one launch for every shard and
column; the HYB remainder and the ELL products gather on the block.
"""
from __future__ import annotations

from typing import Optional

import torch

from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmv_ext
from lssp_tpu_torch.parallel.partition import DistDIA, DistELL, DistHYB
from lssp_tpu_torch.solvers.base import dot


def halo_exchange(x2: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(P, R) → (P, lo + R + hi), or (P, R, k) → (P, lo + R + hi, k) for a
    block: shard p's rows between the last ``lo`` rows of shard p−1 and
    the first ``hi`` rows of shard p+1.  The ring
    wraps around unmasked, as the ``ppermute`` pair does: shard 0's left
    halo holds shard P−1's tail and shard P−1's right halo shard 0's head,
    which a DistDIA only ever multiplies by stored zeros."""
    parts = []
    if lo > 0:
        parts.append(torch.roll(x2[:, -lo:], 1, dims=0))
    parts.append(x2)
    if hi > 0:
        parts.append(torch.roll(x2[:, :hi], -1, dims=0))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x2


def _dia_local_spmv(M: DistDIA, x_ext: torch.Tensor, alpha: float = 1.0,
                    beta: float = 0.0, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every shard's DIA product over its extended vector, (P, R), or over
    its extended block, (P, R, k): kernel K4 (K4k) on CUDA, its plain
    version on the CPU."""
    fn = dia_spmm_ext if x_ext.ndim == 3 else dia_spmv_ext
    return fn(M.data, M.offsets, x_ext, alpha, beta, z, offsets_t=M.offsets_t)


def _make_dia_spmv(M: DistDIA):
    P, R = M.nshards, M.rows_per_shard

    def op(x):
        x2 = x.view(P, R, *x.shape[1:])
        return _dia_local_spmv(M, halo_exchange(x2, M.lo, M.hi)).view(x.shape)

    return op


def _make_hyb_spmv(M: DistHYB):
    """The band through the DIA halo exchange; the remainder gathers from
    the whole x (the all-gather) and adds into each shard's rows."""
    band_op = _make_dia_spmv(M.band)
    R = M.rows_per_shard
    shard0 = torch.arange(M.nshards, device=M.rem_rows.device)[:, None] * R
    rows = (M.rem_rows + shard0).view(-1)
    cols = M.rem_cols.view(-1)
    vals = M.rem_vals.view(-1)

    def op(x):
        v = vals[:, None] if x.ndim == 2 else vals
        return band_op(x).index_add_(0, rows, v * x[cols])

    return op


def _make_ell_spmv(M: DistELL):
    P, R, h = M.nshards, M.rows_per_shard, M.halo
    k = M.cols.shape[2]
    if M.mode != "halo":
        def gather_all(x):
            if x.ndim == 2:
                return (M.data[..., None] * x[M.cols]).sum(dim=2).view(x.shape)
            return (M.data * x[M.cols]).sum(dim=2).view(-1)
        return gather_all
    cols = M.cols.view(P, R * k)

    def op(x):
        tail = tuple(x.shape[1:])
        x2 = x.view(P, R, *tail)
        if h > 0:
            from_left = torch.roll(x2[:, -h:], 1, dims=0)
            from_right = torch.roll(x2[:, :h], -1, dims=0)
            # the ring wrap-around is masked here: the ELL halo reach is
            # checked for interior shards only
            from_left[0] = 0
            from_right[P - 1] = 0
            x2 = torch.cat([from_left, x2, from_right], dim=1)
        if tail:
            g = x2.gather(1, cols[..., None].expand(P, R * k, *tail)).view(P, R, k, *tail)
            return (M.data[..., None] * g).sum(dim=2).view(x.shape)
        return (M.data * x2.gather(1, cols).view(P, R, k)).sum(dim=2).view(-1)

    return op


def make_dist_spmv(M):
    """``op(x) -> A@x`` on the flat vector for a DistDIA, DistHYB or
    DistELL (halo or all-gather mode).  ``op.shards`` is the shard count:
    a solver whose JAX form draws state per shard inside ``shard_map``
    (IDR(s)'s shadow space) reads it."""
    if isinstance(M, DistHYB):
        op = _make_hyb_spmv(M)
    elif isinstance(M, DistDIA):
        op = _make_dia_spmv(M)
    elif isinstance(M, DistELL):
        op = _make_ell_spmv(M)
    else:
        raise TypeError(f"unsupported distributed matrix {type(M)}")
    op.shards = M.nshards
    return op


def apply_dist_spmv(M, x: torch.Tensor) -> torch.Tensor:
    """A@x for a partitioned matrix, once."""
    return make_dist_spmv(M)(x)


def make_psum_dot(nshards: int):
    """Distributed ⟨x, y⟩: per-shard partial sums, then a sum over the
    shard axis (the ``psum``); a 0-d tensor."""
    def pdot(x, y):
        return dot(x.view(nshards, -1).T, y.view(nshards, -1).T).sum()

    return pdot

