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

``make_dist_spmv_t`` is the transpose (bicg, qmr, cgnr, lsqr over the
mesh): the reverse of the halo exchange, each shard's accumulation into
its halo slots added back into the neighbour that owns those rows; the
all-gather paths' ``psum_scatter`` is one scatter-add into the flat
vector.  Plain PyTorch, as it is XLA in the JAX package.
``OpWithTranspose`` carries it beside the forward operator.
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


def dia_shard_t(data: torch.Tensor, offsets, x2: torch.Tensor, lo: int, hi: int):
    """Every shard's transposed band product into its extended frame:
    (P, lo + R + hi[, k]), row r of diagonal d adding data[p, d, r]·x[p, r]
    into slot lo + r + off_d (JAX's ``_make_dia_spmv_t`` before its
    exchange)."""
    P, _, R = data.shape
    tail = tuple(x2.shape[2:])
    z = x2.new_zeros((P, lo + R + hi) + tail, dtype=torch.promote_types(data.dtype, x2.dtype))
    for d, off in enumerate(offsets):
        z[:, lo + off:lo + off + R] += (data[:, d, :, None] if tail else data[:, d]) * x2
    return z


def _make_dia_spmv_t(M: DistDIA):
    P, R, lo, hi = M.nshards, M.rows_per_shard, M.lo, M.hi

    def op_t(x):
        z = dia_shard_t(M.data, M.offsets, x.view(P, R, *x.shape[1:]), lo, hi)
        y = z[:, lo:lo + R].clone()
        # a shard's left-halo sums belong to the last lo rows of shard p−1,
        # its right-halo sums to the first hi rows of shard p+1; the ring
        # wrap adds sums of stored zeros
        if lo > 0:
            y[:, R - lo:] += torch.roll(z[:, :lo], -1, dims=0)
        if hi > 0:
            y[:, :hi] += torch.roll(z[:, lo + R:], 1, dims=0)
        return y.view(x.shape)

    return op_t


def _make_hyb_spmv_t(M: DistHYB):
    """The band's transpose, then each remainder entry (local row r, global
    column c) adds v·x[r] into row c of the flat result."""
    band_t = _make_dia_spmv_t(M.band)
    R = M.rows_per_shard
    shard0 = torch.arange(M.nshards, device=M.rem_rows.device)[:, None] * R
    rows = (M.rem_rows + shard0).view(-1)
    cols = M.rem_cols.view(-1)
    vals = M.rem_vals.view(-1)

    def op_t(x):
        v = vals[:, None] if x.ndim == 2 else vals
        return band_t(x).index_add_(0, cols, v * x[rows])

    return op_t


def _make_ell_spmv_t(M: DistELL):
    P, R, h = M.nshards, M.rows_per_shard, M.halo

    def op_t(x):
        tail = tuple(x.shape[1:])
        x2 = x.view(P, R, *tail)
        prod = (M.data[..., None] * x2[:, :, None] if tail else M.data * x2[..., None])
        if M.mode != "halo":
            y = x.new_zeros((M.n,) + tail, dtype=prod.dtype)
            return y.index_add_(0, M.cols.reshape(-1), prod.reshape((-1,) + tail))
        # each shard's sums into its frame [halo_l | rows | halo_r], then the
        # halo sums to the neighbours that own them (not wrapped: the ELL
        # halo reach is checked for interior shards only)
        z = x.new_zeros((P * (R + 2 * h),) + tail, dtype=prod.dtype)
        frame = (M.cols + torch.arange(P, device=x.device)[:, None, None] * (R + 2 * h))
        z = z.index_add_(0, frame.reshape(-1), prod.reshape((-1,) + tail))
        z = z.view(P, R + 2 * h, *tail)
        y = z[:, h:h + R].clone()
        if h > 0:
            y[:P - 1, R - h:] += z[1:, :h]
            y[1:, :h] += z[:P - 1, h + R:]
        return y.view(x.shape)

    return op_t


def make_dist_spmv_t(M):
    """``op_t(x) -> Aᵀ@x`` on the flat vector (or an (n, k) block) for a
    DistDIA, DistHYB or DistELL: JAX's ``make_dist_spmv_t``."""
    if isinstance(M, DistHYB):
        return _make_hyb_spmv_t(M)
    if isinstance(M, DistDIA):
        return _make_dia_spmv_t(M)
    if isinstance(M, DistELL):
        return _make_ell_spmv_t(M)
    raise TypeError(f"unsupported distributed matrix {type(M)}")


class OpWithTranspose:
    """A matrix-free operator carrying its transpose as ``t_op``, which
    ``solvers/base.operator_t`` takes, so that bicg, qmr, cgnr and lsqr run
    on it; ``shards`` as in ``make_dist_spmv``."""

    def __init__(self, op, op_t):
        self._op = op
        self.t_op = op_t
        self.shards = getattr(op, "shards", None)

    def __call__(self, x):
        return self._op(x)


def apply_dist_spmv(M, x: torch.Tensor) -> torch.Tensor:
    """A@x for a partitioned matrix, once."""
    return make_dist_spmv(M)(x)


def psum(partials: torch.Tensor) -> torch.Tensor:
    """The reduction over the shards: the per-shard partial sums on the
    last axis, summed (JAX's ``lax.psum``).  Every reduction of
    ``make_psum_dot``'s dot goes through here once."""
    return partials.sum(dim=-1)


def make_psum_dot(nshards: int):
    """Distributed ⟨x, y⟩: each shard's partial sum, then one ``psum`` over
    the shard axis; a 0-d tensor for flat (n,) vectors, (k,) for (n, k)
    blocks.  The distributed launcher hands it to every method as its
    ``dot`` (JAX's ``parallel/dist_ops.make_psum_dot``).  ``.many(pairs)``
    gives the inner products of all the pairs from ONE stacked ``psum`` of
    their partials and ``.rows(V, w)`` all ⟨V[j], w⟩ from one ``psum`` of
    the coefficient vector, the communication-avoiding contract of pipecg
    and cagmres (``solvers/base.dot_many`` / ``dot_rows``).  On the CPU a
    partial sums in ``base.dot``'s order; on the card the partials of every
    shard (and column) are one reduction."""
    def partial(x, y):
        # (R, [k,] P): shard p's rows in the last index, summed over the rows
        xs = x.view(nshards, -1, *x.shape[1:]).movedim(0, -1)
        ys = y.view(nshards, -1, *y.shape[1:]).movedim(0, -1)
        if x.device.type != "cpu":
            return (xs * ys).sum(dim=0)
        return dot(xs, ys)

    def pdot(x, y):
        return psum(partial(x, y))

    def many(pairs):
        glob = psum(torch.stack([partial(a, b) for a, b in pairs]))
        return tuple(glob[i] for i in range(len(pairs)))

    def rows(V, w):
        return psum(torch.stack([partial(V[j], w) for j in range(V.shape[0])]))

    pdot.many = many
    pdot.rows = rows
    return pdot

