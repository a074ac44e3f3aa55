"""Level-scheduled block triangular solves for the block-ILU path
(``lssp_tpu/ops/block_trisolve.py``).

Rows are bs-sized block rows and the off-diagonal entries dense bs×bs
blocks.  The schedule is built on the host exactly as the JAX package
builds it (the same levels, padding and slot order), then moved to the
device; a sweep walks the levels in order, each level one gather of the
solved block rows it reads, one batched block product and one scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from lssp_tpu_torch.ops.spmv import _block_mv


@dataclasses.dataclass(frozen=True)
class BlockTriSchedule:
    rows: Any       # (nlev, w) int64 block-row ids, padded with nrowb
    cols: Any       # (nlev, w, k) int64 block-col ids, padded with nrowb
    vals: Any       # (nlev, w, k, bs, bs) blocks, padded 0
    nrowb: int
    bs: int

    @property
    def nlevels(self) -> int:
        return int(self.rows.shape[0])


def block_level_schedule(indptr, indices, blocks, nrowb: int, bs: int, lower: bool,
                         device="cpu") -> BlockTriSchedule:
    """The schedule of a *strict* block-triangular BSR structure: a block row's
    level is one more than the deepest row it reads; each level's rows
    are padded to the widest level, and each row's blocks to the longest
    row.  Host arithmetic as in the JAX package, tensors on ``device``."""
    ip = np.asarray(indptr).astype(np.int64)
    idx = np.asarray(indices).astype(np.int64)
    blk = np.asarray(blocks)
    lev = np.zeros(nrowb, dtype=np.int64)
    for i in (range(nrowb) if lower else range(nrowb - 1, -1, -1)):
        s, e = ip[i], ip[i + 1]
        if e > s:
            lev[i] = lev[idx[s:e]].max() + 1
    nlev = int(lev.max()) + 1 if nrowb else 1
    order = np.argsort(lev, kind="stable")
    counts = np.bincount(lev, minlength=nlev)
    w = max(1, int(counts.max()))
    k = max(1, int((ip[1:] - ip[:-1]).max()) if nrowb else 1)
    rows = np.full((nlev, w), nrowb, dtype=np.int64)
    cols = np.full((nlev, w, k), nrowb, dtype=np.int64)
    vals = np.zeros((nlev, w, k, bs, bs), dtype=blk.dtype)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for lv in range(nlev):
        rs = order[starts[lv]:starts[lv + 1]]
        rows[lv, :len(rs)] = rs
        for slot, r in enumerate(rs):
            s, e = ip[r], ip[r + 1]
            cols[lv, slot, :e - s] = idx[s:e]
            vals[lv, slot, :e - s] = blk[s:e]
    return BlockTriSchedule(rows=torch.from_numpy(rows).to(device),
                            cols=torch.from_numpy(cols).to(device),
                            vals=torch.from_numpy(vals).to(device), nrowb=nrowb, bs=bs)


def block_trisweep(sched: BlockTriSchedule, b: torch.Tensor) -> torch.Tensor:
    """Solve (I + T) y = b, T the strict block-triangular part the schedule
    holds (unit block diagonal); ``b`` (n,) or an (n, k) block.  Padded
    slots read and write block row ``nrowb``, a zero row past the end."""
    nrowb, bs = sched.nrowb, sched.bs
    tail = tuple(b.shape[1:])
    bb = b.reshape((nrowb, bs) + tail)
    be = torch.cat([bb, bb.new_zeros((1, bs) + tail)])
    ye = torch.zeros_like(be)
    for lv in range(sched.nlevels):
        rows, cols, vals = sched.rows[lv], sched.cols[lv], sched.vals[lv]
        w, k = cols.shape
        prod = _block_mv(vals.reshape(w * k, bs, bs), ye[cols.reshape(-1)])
        ye[rows] = be[rows] - prod.reshape((w, k, bs) + tail).sum(dim=1)
    return ye[:nrowb].reshape(b.shape)


def block_diag_apply(dinv: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z_i = Dinv_i · y_i for every block row; ``y`` (n,) or (n, k)."""
    nrowb, bs = dinv.shape[0], dinv.shape[1]
    return _block_mv(dinv, y.reshape((nrowb, bs) + tuple(y.shape[1:]))).reshape(y.shape)
