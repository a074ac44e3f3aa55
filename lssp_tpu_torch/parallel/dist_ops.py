"""Distributed products and reductions on a shard mesh.

The JAX package runs these per shard under ``shard_map``: the halo exchange
is two ring ``ppermute`` shifts and a dot is a local sum plus ``psum``.
Here a rank holds its P_loc shards as the leading axis of one tensor, so
between two of its own shards a ``ppermute`` is a shift along that axis
(``torch.roll``), and a ``psum`` is a sum over the shard axis.  Every
operator takes and returns the rank's flat (n_loc,) vector, or an (n_loc,
k) block (the layout of ``ops/spmv.py``, viewed as (P_loc, R, k)); global
shard p owns rows [p·R, (p+1)·R), and rank r the shards [r·P_loc,
(r+1)·P_loc).  A DIA band's block product is kernel K4k, one launch for
every shard and column; the HYB remainder and the ELL products gather on
the block.

Across ranks (a ``Mesh`` with a ``torch.distributed`` group: NCCL on the
card, gloo on the CPU) the communicator is:

- the halo rows of a rank's first and last shards: one
  ``batch_isend_irecv`` with the neighbouring ranks of the ring
  (``_ring_swap``);
- the whole x of a HYB remainder or an all-gather ELL, and the whole
  level vector of a classical AMG product, of an AMG coarse solve
  (``dense_rows``) or of the Spike interface: one all-gather;
- a ``psum``: one all-gather of every rank's per-shard partials, laid out
  in global shard order and summed as on one rank, so a dot over W ranks
  is bitwise the one-process dot wherever the partials are;
- the transposes' ``psum_scatter``: each rank's full-length accumulation
  sent slice by slice (one all-to-all), the W slices summed in rank order.
- at build time, the statistics a rank-local build's shared choices are
  made from: one all-gather of every rank's pickled object
  (``gather_objects``).

At world size 1 the two kinds differ on purpose.  The point-to-point
exchanges and the all-to-all are skipped (``_spans``): the ring is the
rank's own, and an NCCL send to oneself can hang.  The all-gathers still
run as collectives of one (``_grouped``), so a group of one, the only
group a one-card machine can hold, drives NCCL in every dot and gather
and checks it there.

Every sum over ranks runs in rank order, never in an order a library
picks, so every rank gets the same bits and takes the same branch.
``collectives`` counts the collective calls by kind, and each call, its
wait included, is the span ``lssp.comm.all_gather``, ``all_to_all`` or
``p2p``.  Without a group
(``mesh=None`` or ``mesh.group is None``) nothing here communicates.

``make_dist_spmv_t`` is the transpose (bicg, qmr, cgnr, lsqr over the
mesh): the reverse of the halo exchange, each shard's accumulation into
its halo slots added back into the neighbour that owns those rows; the
all-gather paths' ``psum_scatter`` is one scatter-add into the flat
vector.  Plain PyTorch, as it is XLA in the JAX package.
``OpWithTranspose`` carries it beside the forward operator.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmv_ext
from lssp_tpu_torch.parallel.partition import DistDIA, DistELL, DistHYB
from lssp_tpu_torch.solvers.base import dot
from lssp_tpu_torch.utils.profile import annotate

# collective calls by kind ("all_gather", "all_to_all", "p2p"), for the
# per-iteration counts of a distributed solve; callers reset it
collectives = collections.Counter()


def _grouped(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _spans(mesh) -> bool:
    """Whether the shard ring crosses ranks (a group of world size > 1)."""
    return _grouped(mesh) and mesh.world > 1


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """(W, *t.shape): every rank's ``t`` in rank order, one all-gather."""
    import torch.distributed as dist
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    out = t.new_empty(mesh.world * t.numel())
    with annotate("lssp.comm.all_gather"):
        gather(out, t.contiguous().view(-1), group=mesh.group)
    collectives["all_gather"] += 1
    return out.view(mesh.world, *t.shape)


def gather_objects(obj, mesh) -> list:
    """Every rank's picklable ``obj`` in rank order (``[obj]`` without a
    group): the statistics a build's shared choices are made from.  Two
    all-gathers of the same kind as a dot's, on the mesh's device: the
    pickles' sizes, then the pickles padded to the largest."""
    if not _grouped(mesh):
        return [obj]
    import pickle
    data = pickle.dumps(obj)
    size = torch.tensor([len(data)], dtype=torch.int64, device=mesh.device)
    sizes = all_gather(size, mesh).view(-1).tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    parts = all_gather(buf.to(mesh.device), mesh).cpu().numpy()
    return [pickle.loads(parts[r, :n].tobytes()) for r, n in enumerate(sizes)]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (n[, k]) from every rank's (n_loc[, k]) rows; ``x`` itself
    without a group."""
    if not _grouped(mesh):
        return x
    return all_gather(x, mesh).view(-1, *x.shape[1:])


def dense_rows(inv: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``inv @ b_full``, b_full the whole vector (or
    block) gathered from every rank's rows ``b``: the AMG cycles' dense
    coarse solve.  Every rank forms the whole product, as one process
    does, so its rows are bitwise the one-process rows (JAX keeps row
    shards of ``inv``, which saves only the flops)."""
    x = inv @ gather_rows(b, mesh)
    if not _grouped(mesh):
        return x
    n = b.shape[0]
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def rank_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over the ranks of ``t``, in rank order (the block solvers'
    ``reduce``; JAX's ``lax.psum``): bitwise ``t`` at world size 1."""
    parts = all_gather(t, mesh)
    acc = parts[0]
    for r in range(1, mesh.world):
        acc = acc + parts[r]
    return acc


def _scatter_sum(full: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of Σ_r full_r for a full-length (W·n_loc[, k])
    accumulation on every rank (JAX's ``psum_scatter``): one all-to-all,
    the W slices summed in rank order."""
    if not _spans(mesh):
        return full
    import torch.distributed as dist
    recv = torch.empty_like(full)
    with annotate("lssp.comm.all_to_all"):
        dist.all_to_all_single(recv, full.contiguous(), group=mesh.group)
    collectives["all_to_all"] += 1
    parts = recv.view(mesh.world, -1, *full.shape[1:])
    acc = parts[0]
    for r in range(1, mesh.world):
        acc = acc + parts[r]
    return acc


def _ring_swap(to_next: Optional[torch.Tensor], to_prev: Optional[torch.Tensor], mesh):
    """Send ``to_next`` to rank r+1 and ``to_prev`` to rank r−1 of the ring;
    returns (what rank r−1 sent forward, what rank r+1 sent back), in one
    ``batch_isend_irecv``.  Every rank posts the same sequence (the halo
    widths are the partition's), so the pairs match also at world size 2,
    where both neighbours are one rank."""
    import torch.distributed as dist
    g, W = mesh.group, mesh.world
    nxt = dist.get_global_rank(g, (mesh.rank + 1) % W)
    prv = dist.get_global_rank(g, (mesh.rank - 1) % W)
    ops, from_prev, from_next = [], None, None
    if to_next is not None:
        from_prev = torch.empty_like(to_next)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), nxt, g, tag=1),
                dist.P2POp(dist.irecv, from_prev, prv, g, tag=1)]
    if to_prev is not None:
        from_next = torch.empty_like(to_prev)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), prv, g, tag=2),
                dist.P2POp(dist.irecv, from_next, nxt, g, tag=2)]
    if ops:
        with annotate("lssp.comm.p2p"):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        collectives["p2p"] += 1
    return from_prev, from_next


def _edges(mesh):
    """Whether this rank holds global shard 0 and global shard P−1."""
    if not _grouped(mesh):
        return True, True
    return mesh.rank == 0, mesh.rank == mesh.world - 1


def halo_exchange(x2: torch.Tensor, lo: int, hi: int, mesh=None,
                  wrap: bool = True) -> torch.Tensor:
    """(P, R) → (P, lo + R + hi), or (P, R, k) → (P, lo + R + hi, k) for a
    block: shard p's rows between the last ``lo`` rows of shard p−1 and
    the first ``hi`` rows of shard p+1, across ranks through ``mesh``'s
    group.  The ring wraps around unmasked, as the ``ppermute`` pair does:
    global shard 0's left halo holds shard P−1's tail and shard P−1's right
    halo shard 0's head, which a DistDIA only ever multiplies by stored
    zeros.  ``wrap=False`` zeroes those two halos (the ELL halo mode)."""
    left = torch.roll(x2[:, -lo:], 1, dims=0) if lo > 0 else None
    right = torch.roll(x2[:, :hi], -1, dims=0) if hi > 0 else None
    if _spans(mesh):
        from_prev, from_next = _ring_swap(x2[-1, -lo:] if lo > 0 else None,
                                          x2[0, :hi] if hi > 0 else None, mesh)
        if lo > 0:
            left[0] = from_prev
        if hi > 0:
            right[-1] = from_next
    if not wrap:
        first, last = _edges(mesh)
        if lo > 0 and first:
            left[0] = 0
        if hi > 0 and last:
            right[-1] = 0
    parts = [p for p in (left, x2, right) if p is not None]
    return torch.cat(parts, dim=1) if len(parts) > 1 else x2


def _halo_sum(z: torch.Tensor, lo: int, hi: int, R: int, mesh=None,
              wrap: bool = True) -> torch.Tensor:
    """The reverse of ``halo_exchange``: every shard's sums into its frame
    (P, lo + R + hi[, k]) → its own rows (P, R[, k]), the left-halo sums
    added into the last ``lo`` rows of shard p−1 and the right-halo sums
    into the first ``hi`` rows of shard p+1.  ``wrap=False`` drops the sums
    that would wrap around the ring."""
    y = z[:, lo:lo + R].clone()
    from_next = torch.roll(z[:, :lo], -1, dims=0) if lo > 0 else None
    from_prev = torch.roll(z[:, lo + R:], 1, dims=0) if hi > 0 else None
    if _spans(mesh):
        a, b = _ring_swap(z[-1, lo + R:] if hi > 0 else None,
                          z[0, :lo] if lo > 0 else None, mesh)
        if hi > 0:
            from_prev[0] = a
        if lo > 0:
            from_next[-1] = b
    first, last = _edges(mesh) if not wrap else (False, False)
    P = z.shape[0]
    if lo > 0:
        end = P - 1 if last else P
        y[:end, R - lo:] += from_next[:end]
    if hi > 0:
        start = 1 if first else 0
        y[start:, :hi] += from_prev[start:]
    return y


def _dia_local_spmv(M: DistDIA, x_ext: torch.Tensor, alpha: float = 1.0,
                    beta: float = 0.0, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every shard's DIA product over its extended vector, (P, R), or over
    its extended block, (P, R, k): kernel K4 (K4k) on CUDA, its plain
    version on the CPU."""
    fn = dia_spmm_ext if x_ext.ndim == 3 else dia_spmv_ext
    return fn(M.data, M.offsets, x_ext, alpha, beta, z, offsets_t=M.offsets_t)


def _make_dia_spmv(M: DistDIA, mesh=None):
    P, R = M.nshards, M.rows_per_shard

    def op(x):
        x2 = x.view(P, R, *x.shape[1:])
        return _dia_local_spmv(M, halo_exchange(x2, M.lo, M.hi, mesh)).view(x.shape)

    return op


def _remainder_index(M: DistHYB):
    R = M.rows_per_shard
    shard0 = torch.arange(M.nshards, device=M.rem_rows.device)[:, None] * R
    return (M.rem_rows + shard0).view(-1), M.rem_cols.view(-1), M.rem_vals.view(-1)


def _make_hyb_spmv(M: DistHYB, mesh=None):
    """The band through the DIA halo exchange; the remainder gathers from
    the whole x (the all-gather) and adds into each shard's rows."""
    band_op = _make_dia_spmv(M.band, mesh)
    rows, cols, vals = _remainder_index(M)

    def op(x):
        v = vals[:, None] if x.ndim == 2 else vals
        return band_op(x).index_add_(0, rows, v * gather_rows(x, mesh)[cols])

    return op


def _make_ell_spmv(M: DistELL, mesh=None):
    P, R, h = M.nshards, M.rows_per_shard, M.halo
    k = M.cols.shape[2]
    if M.mode != "halo":
        def gather_all(x):
            xf = gather_rows(x, mesh)
            if x.ndim == 2:
                return (M.data[..., None] * xf[M.cols]).sum(dim=2).view(x.shape)
            return (M.data * xf[M.cols]).sum(dim=2).view(-1)
        return gather_all
    cols = M.cols.view(P, R * k)

    def op(x):
        tail = tuple(x.shape[1:])
        # the ring wrap-around is masked here: the ELL halo reach is checked
        # for interior shards only
        x2 = halo_exchange(x.view(P, R, *tail), h, h, mesh, wrap=False)
        if tail:
            g = x2.gather(1, cols[..., None].expand(P, R * k, *tail)).view(P, R, k, *tail)
            return (M.data[..., None] * g).sum(dim=2).view(x.shape)
        return (M.data * x2.gather(1, cols).view(P, R, k)).sum(dim=2).view(-1)

    return op


def make_dist_spmv(M, mesh=None):
    """``op(x) -> A@x`` on the rank's flat rows for a DistDIA, DistHYB or
    DistELL (halo or all-gather mode), communicating through ``mesh``'s
    group when it has one.  ``op.shards`` is the rank's shard count: a
    solver whose JAX form draws state per shard inside ``shard_map``
    (IDR(s)'s shadow space) reads it."""
    if isinstance(M, DistHYB):
        op = _make_hyb_spmv(M, mesh)
    elif isinstance(M, DistDIA):
        op = _make_dia_spmv(M, mesh)
    elif isinstance(M, DistELL):
        op = _make_ell_spmv(M, mesh)
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


def _make_dia_spmv_t(M: DistDIA, mesh=None):
    P, R, lo, hi = M.nshards, M.rows_per_shard, M.lo, M.hi

    def op_t(x):
        z = dia_shard_t(M.data, M.offsets, x.view(P, R, *x.shape[1:]), lo, hi)
        # the ring wrap adds sums of stored zeros
        return _halo_sum(z, lo, hi, R, mesh).view(x.shape)

    return op_t


def _make_hyb_spmv_t(M: DistHYB, mesh=None):
    """The band's transpose, then each remainder entry (local row r, global
    column c) adds v·x[r] into row c of the result; across ranks into a
    full-length accumulation, summed over the ranks and sliced."""
    band_t = _make_dia_spmv_t(M.band, mesh)
    rows, cols, vals = _remainder_index(M)

    def op_t(x):
        v = vals[:, None] if x.ndim == 2 else vals
        if not _grouped(mesh):
            return band_t(x).index_add_(0, cols, v * x[rows])
        full = x.new_zeros((mesh.world * x.shape[0],) + tuple(x.shape[1:]))
        return band_t(x) + _scatter_sum(full.index_add_(0, cols, v * x[rows]), mesh)

    return op_t


def _make_ell_spmv_t(M: DistELL, mesh=None):
    P, R, h = M.nshards, M.rows_per_shard, M.halo

    def op_t(x):
        tail = tuple(x.shape[1:])
        x2 = x.view(P, R, *tail)
        prod = (M.data[..., None] * x2[:, :, None] if tail else M.data * x2[..., None])
        if M.mode != "halo":
            world = mesh.world if _grouped(mesh) else 1
            y = x.new_zeros((world * x.shape[0],) + tail, dtype=prod.dtype)
            y = y.index_add_(0, M.cols.reshape(-1), prod.reshape((-1,) + tail))
            return _scatter_sum(y, mesh)
        # each shard's sums into its frame [halo_l | rows | halo_r], then the
        # halo sums to the neighbours that own them (not wrapped: the ELL
        # halo reach is checked for interior shards only)
        z = x.new_zeros((P * (R + 2 * h),) + tail, dtype=prod.dtype)
        frame = (M.cols + torch.arange(P, device=x.device)[:, None, None] * (R + 2 * h))
        z = z.index_add_(0, frame.reshape(-1), prod.reshape((-1,) + tail))
        return _halo_sum(z.view(P, R + 2 * h, *tail), h, h, R, mesh, wrap=False).view(x.shape)

    return op_t


def make_dist_spmv_t(M, mesh=None):
    """``op_t(x) -> Aᵀ@x`` on the rank's flat rows (or an (n_loc, k) block)
    for a DistDIA, DistHYB or DistELL: JAX's ``make_dist_spmv_t``."""
    if isinstance(M, DistHYB):
        return _make_hyb_spmv_t(M, mesh)
    if isinstance(M, DistDIA):
        return _make_dia_spmv_t(M, mesh)
    if isinstance(M, DistELL):
        return _make_ell_spmv_t(M, mesh)
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
    """The reduction over the shards: the per-shard partial sums of every
    global shard on the last axis, summed (JAX's ``lax.psum``).  Every
    reduction of ``make_psum_dot``'s dot goes through here once."""
    return partials.sum(dim=-1)


def _global_partials(partials: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's per-shard partials (last axis: its P_loc shards), laid
    out in global shard order as one process holds them, from one
    all-gather; the rank's own partials without a group."""
    if not _grouped(mesh):
        return partials
    return all_gather(partials, mesh).movedim(0, -2).flatten(-2).contiguous()


def make_psum_dot(nshards: int, mesh=None):
    """Distributed ⟨x, y⟩: each shard's partial sum, then one ``psum`` over
    the shard axis (and the ranks of ``mesh``'s group); a 0-d tensor for
    flat vectors, (k,) for blocks.  ``nshards``: the rank's shards.  The
    distributed launcher hands it to every method as its ``dot`` (JAX's
    ``parallel/dist_ops.make_psum_dot``).  ``.many(pairs)``
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

    def reduce(part):
        return psum(_global_partials(part, mesh))

    def pdot(x, y):
        return reduce(partial(x, y))

    def many(pairs):
        glob = reduce(torch.stack([partial(a, b) for a, b in pairs]))
        return tuple(glob[i] for i in range(len(pairs)))

    def rows(V, w):
        return reduce(torch.stack([partial(V[j], w) for j in range(V.shape[0])]))

    pdot.many = many
    pdot.rows = rows
    return pdot
