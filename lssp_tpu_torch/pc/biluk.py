"""Block ILU on uniform BSR: ``biluk``, ``bilut`` and the variable-block
``vbiluk`` / ``vbilut`` (reference pc-biluk.cxx, pc-bilut.cxx,
pc-vbiluk.cxx, pc-vbilut.cxx; ``lssp_tpu/pc/biluk.py``).

The host factorization is the JAX package's, numpy for numpy, so the
factors are bitwise equal to it:

- block symbolic = scalar ILU(k) on the block pattern (pc-biluk.cxx:328-386);
- block ILU(0) numeric (:198-277): ``A_ik ← A_ik·inv(A_kk)``, then the
  Schur updates ``A_ij −= A_ik·A_kj``; diagonal blocks inverted
  explicitly, a missing one taken as the identity (:265-276);
- the apply (:22-60) is z = Û⁻¹·D·L⁻¹·r with unit-block-diagonal L̂ and Û
  (Û premultiplied by inv(A_ii)) and D = inv(A_ii).

The device apply is chosen as in JAX's ``_pack_bilu_pc``: truncated
Neumann sweeps, each one BDIA product, when ``ilu_sweeps`` resolves to a
positive count (``default_ilu_sweeps``: 6 on CUDA, exact on the CPU) and
both strict factors are block-banded (``bsr_to_bdia(max_diags=48,
fill=3.0)``); the exact block level schedules otherwise.  Variable blocks
are embedded in uniform blocks of the largest size (padded diagonal slots
hold 1), the uniform machinery runs, and the apply scatters r in and
gathers z back.  Every apply takes r (n,) or an (n, k) block.
"""
from __future__ import annotations

import functools
import heapq

import numpy as np
import torch

from lssp_tpu_torch.ops.block_trisolve import (
    block_diag_apply, block_level_schedule, block_trisweep,
)
from lssp_tpu_torch.ops.spmv import spmv
from lssp_tpu_torch.ops.trisolve import default_ilu_sweeps, neumann_exact_depth
from lssp_tpu_torch.pc.base import Preconditioner, register_pc
from lssp_tpu_torch.pc.ilu_host import iluk_symbolic
from lssp_tpu_torch.sparse.convert import bsr_to_bdia, csr_to_bsr
from lssp_tpu_torch.sparse.types import BSR, CSR


def _block_symbolic(A: BSR, level: int) -> BSR:
    """Scalar ILU(k) symbolic on the block pattern; A's blocks scattered onto
    the grown pattern, fill blocks zero."""
    if level <= 0:
        return A
    nrowb, bs = A.nrowb, A.blocksize
    pat = CSR(A.indptr, A.indices, np.zeros(A.nnzb, dtype=A.blocks.dtype), (nrowb, nrowb))
    grown = iluk_symbolic(pat, level)
    gip = np.asarray(grown.indptr).astype(np.int64)
    gidx = np.asarray(grown.indices).astype(np.int64)
    blocks = np.zeros((len(gidx), bs, bs), dtype=A.blocks.dtype)
    aip = np.asarray(A.indptr).astype(np.int64)
    aidx = np.asarray(A.indices).astype(np.int64)
    for i in range(nrowb):
        loc = np.searchsorted(gidx[gip[i]:gip[i + 1]], aidx[aip[i]:aip[i + 1]])
        blocks[gip[i] + loc] = np.asarray(A.blocks)[aip[i]:aip[i + 1]]
    return BSR(gip.astype(np.int32), gidx.astype(np.int32), blocks, A.shape, bs)


def bilu0_factor_bsr(T: BSR):
    """Block ILU(0) on the fixed block pattern of ``T`` (on a copy).  Returns
    (blocks, inv): the combined factor blocks and the inverted diagonal
    block of every block row."""
    nrowb, bs = T.nrowb, T.blocksize
    ip = np.asarray(T.indptr).astype(np.int64)
    idx = np.asarray(T.indices).astype(np.int64)
    blocks = np.asarray(T.blocks).copy()
    inv = np.zeros((nrowb, bs, bs), dtype=blocks.dtype)
    eye = np.eye(bs, dtype=blocks.dtype)
    posmap = np.full(nrowb, -1, dtype=np.int64)
    for i in range(nrowb):
        s, e = ip[i], ip[i + 1]
        posmap[idx[s:e]] = np.arange(s, e)
        kpos = s
        while kpos < e and idx[kpos] < i:
            k = idx[kpos]
            a_ik = blocks[kpos] @ inv[k]
            blocks[kpos] = a_ik
            ks, ke = ip[k], ip[k + 1]
            tp = posmap[idx[ks:ke]]
            mask = tp > kpos
            if mask.any():
                blocks[tp[mask]] -= a_ik @ blocks[ks:ke][mask]     # Schur updates
            kpos += 1
        posmap[idx[s:e]] = -1
        if kpos < e and idx[kpos] == i:
            inv[i] = np.linalg.inv(blocks[kpos])
        else:
            inv[i] = eye                                           # missing diagonal block
    return blocks, inv


def biluk_factor_bsr(A: BSR, level: int = 1):
    """Block ILU(k): the strict factors as CSR-of-blocks triples,
    ((lp, lc, lb), Dinv, (up, uc, ub)), Û's blocks premultiplied by
    inv(A_ii) (pc-biluk.cxx:162)."""
    T = _block_symbolic(A, level)
    blocks, inv = bilu0_factor_bsr(T)
    nrowb = T.nrowb
    ip = np.asarray(T.indptr).astype(np.int64)
    idx = np.asarray(T.indices).astype(np.int64)
    rows = np.repeat(np.arange(nrowb, dtype=np.int64), ip[1:] - ip[:-1])

    def strict(mask, transform=None):
        r, c = rows[mask], idx[mask]
        blk = blocks[mask]
        if transform is not None:
            blk = transform(r, blk)
        p = np.zeros(nrowb + 1, dtype=np.int64)
        np.add.at(p, r + 1, 1)
        order = np.lexsort((c, r))
        return np.cumsum(p), c[order], blk[order]

    return (strict(idx < rows), inv,
            strict(idx > rows, transform=lambda r, blk: inv[r] @ blk))


def bilut_factor_bsr(A: BSR, tol: float = 1e-3, p: int = -1):
    """Block ILUT (the reference's ITSOL BILUT capability, pc-bilut.cxx:12-112,
    with uniform blocks): a block is dropped when its Frobenius norm is
    below ``tol`` times the mean block norm of its row, and at most ``p``
    blocks (largest first) are kept in each of L and U (p < 0: the average
    block-row fill of A).  Returns the triples of ``biluk_factor_bsr``."""
    nrowb, bs = A.nrowb, A.blocksize
    ip = np.asarray(A.indptr).astype(np.int64)
    idx = np.asarray(A.indices).astype(np.int64)
    ablocks = np.asarray(A.blocks)
    if p is None or p < 0:
        p = max(1, int(np.ceil(A.nnzb / max(1, nrowb))))
    eye = np.eye(bs, dtype=ablocks.dtype)
    Urows, Lrows = [], []
    Linv = np.zeros((nrowb, bs, bs), dtype=ablocks.dtype)
    for i in range(nrowb):
        s, e = ip[i], ip[i + 1]
        w = {int(c): ablocks[q].copy() for q, c in zip(range(s, e), idx[s:e])}
        droptol = tol * float(np.mean([np.linalg.norm(b) for b in w.values()]))
        # ascending worklist: U-row updates can add fill at k < j < i, which
        # must itself be eliminated
        pending = [c for c in w if c < i]
        heapq.heapify(pending)
        done = set()
        while pending:
            k = heapq.heappop(pending)
            if k in done or k not in w:
                continue
            done.add(k)
            a_ik = w[k] @ Linv[k]
            if np.linalg.norm(a_ik) < droptol:
                del w[k]
                continue
            w[k] = a_ik
            for j, u_kj in zip(*Urows[k]):
                upd = a_ik @ u_kj
                j = int(j)
                if j in w:
                    w[j] -= upd
                elif np.linalg.norm(upd) >= droptol:
                    w[j] = -upd
                    if j < i:
                        heapq.heappush(pending, j)
        diag = w.pop(i, None)

        def keep_largest(cols):
            if len(cols) <= p:
                return cols
            norms = np.array([np.linalg.norm(w[c]) for c in cols])
            return sorted(np.asarray(cols)[np.argsort(-norms)[:p]].tolist())

        lcols = keep_largest(sorted(c for c in w if c < i))
        ucols = keep_largest(sorted(c for c in w if c > i))
        Linv[i] = np.linalg.inv(eye.copy() if diag is None else diag)
        for cols, out in ((lcols, Lrows), (ucols, Urows)):
            out.append((np.asarray(cols, np.int64),
                        np.stack([w[c] for c in cols]) if cols
                        else np.zeros((0, bs, bs), ablocks.dtype)))

    def pack(rows_list, transform=None):
        pptr = np.zeros(nrowb + 1, dtype=np.int64)
        for i, (c, _) in enumerate(rows_list):
            pptr[i + 1] = pptr[i] + len(c)
        cols = (np.concatenate([c for c, _ in rows_list]) if pptr[-1]
                else np.zeros(0, np.int64))
        blks = (np.concatenate([b for _, b in rows_list]) if pptr[-1]
                else np.zeros((0, bs, bs), ablocks.dtype))
        if transform is not None and len(blks):
            blks = transform(np.repeat(np.arange(nrowb), pptr[1:] - pptr[:-1]), blks)
        return pptr, cols, blks

    return pack(Lrows), Linv, pack(Urows, transform=lambda r, blk: Linv[r] @ blk)


def _bilu_apply(state, r):
    """The exact apply: z = Û⁻¹·D·L̂⁻¹·r by block level schedules."""
    sched_l, dinv, sched_u = state
    return block_trisweep(sched_u, block_diag_apply(dinv, block_trisweep(sched_l, r)))


def _bilu_neumann_apply(sweeps, state, r):
    """The unit-block factors inverted as truncated Neumann series, each
    sweep one BDIA product (JAX's ``_bilu_neumann_apply``)."""
    Lb, dinv, Ub = state
    y = r
    for _ in range(sweeps):
        y = r - spmv(Lb, y)
    z = block_diag_apply(dinv, y)
    w = z
    for _ in range(sweeps):
        w = z - spmv(Ub, w)
    return w


def pack_bilu_pc(factors, name: str, sweeps, device) -> Preconditioner:
    """The block-ILU preconditioner on ``device`` from the strict factor
    triples: Neumann sweeps over BDIA factors when ``sweeps`` resolves to a
    positive count and the factors are block-banded, the exact block level
    schedules otherwise.  ``sweeps=None``: ``default_ilu_sweeps(device)``;
    -1: the complete series, exact at the block dependency depth."""
    (lp, lc, lb), inv, (up, uc, ub) = factors
    nrowb, bs = len(lp) - 1, inv.shape[1]
    if sweeps is None:
        sweeps = default_ilu_sweeps(device)
    if sweeps == -1:
        sweeps = neumann_exact_depth([(lp, lc, nrowb, True), (up, uc, nrowb, False)])
    dinv = torch.from_numpy(inv).to(device)
    if sweeps > 0:
        n = nrowb * bs
        try:
            Lb = bsr_to_bdia(BSR(lp, lc, lb, (n, n), bs), max_diags=48, fill=3.0,
                             device=device)
            Ub = bsr_to_bdia(BSR(up, uc, ub, (n, n), bs), max_diags=48, fill=3.0,
                             device=device)
            return Preconditioner(functools.partial(_bilu_neumann_apply, sweeps),
                                  state=(Lb, dinv, Ub), name=f"{name}-n{sweeps}")
        except ValueError:
            pass                    # not block-banded: exact schedules
    state = (block_level_schedule(lp, lc, lb, nrowb, bs, lower=True, device=device), dinv,
             block_level_schedule(up, uc, ub, nrowb, bs, lower=False, device=device))
    return Preconditioner(_bilu_apply, state=state, name=name)


def _to_bsr(A, opts) -> BSR:
    """A as uniform BSR: bs = ``block_size``, else n / ``num_blocks``
    (pc-biluk.cxx:418-431 requires num_blocks)."""
    if isinstance(A, BSR):
        return A
    if opts.block_size:
        bs = int(opts.block_size)
    elif opts.num_blocks:
        bs = A.shape[0] // int(opts.num_blocks)
    else:
        raise ValueError("block ILU needs PCOptions.num_blocks or .block_size "
                         "(reference requires s.num_blks, pc-biluk.cxx:424)")
    return csr_to_bsr(A, bs)


@register_pc("biluk")
def setup_biluk(A, opts, device):
    """Block ILU(k) at ``iluk_level`` (reference lssp_pc_biluk_assemble)."""
    factors = biluk_factor_bsr(_to_bsr(A, opts), level=opts.iluk_level)
    return pack_bilu_pc(factors, f"biluk({opts.iluk_level})", opts.ilu_sweeps, device)


@register_pc("bilut")
def setup_bilut(A, opts, device):
    """Block ILUT at ``ilut_tol`` / ``ilut_p``."""
    factors = bilut_factor_bsr(_to_bsr(A, opts), tol=opts.ilut_tol, p=opts.ilut_p)
    return pack_bilu_pc(factors, "bilut", opts.ilu_sweeps, device)


def vb_embedding(blk_sizes, n: int):
    """Scalar index → index in the uniform-block space of the largest block:
    (bs_max, n_pad, emb) with emb[i] the padded position of row i."""
    blk_sizes = np.asarray(blk_sizes, dtype=np.int64)
    if blk_sizes.sum() != n:
        raise ValueError("blk_sizes must sum to the matrix size")
    bs = int(blk_sizes.max())
    starts = np.concatenate([[0], np.cumsum(blk_sizes)])[:-1]
    emb = np.concatenate([kb * bs + np.arange(sz, dtype=np.int64)
                          for kb, (st, sz) in enumerate(zip(starts, blk_sizes))])
    return bs, len(blk_sizes) * bs, emb


def vb_embed_matrix(A: CSR, blk_sizes):
    """A embedded in the uniform-block space; the padded diagonal slots hold
    1 so the diagonal blocks stay invertible.  Returns (CSR, bs, n_pad, emb)."""
    n = A.shape[0]
    bs, n_pad, emb = vb_embedding(blk_sizes, n)
    ip = np.asarray(A.indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), ip[1:] - ip[:-1])
    cols = np.asarray(A.indices).astype(np.int64)
    dat = np.asarray(A.data)
    pad = np.setdiff1d(np.arange(n_pad, dtype=np.int64), emb, assume_unique=False)
    r = np.concatenate([emb[rows], pad])
    c = np.concatenate([emb[cols], pad])
    v = np.concatenate([dat, np.ones(len(pad), dtype=dat.dtype)])
    order = np.lexsort((c, r))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n_pad))]).astype(np.int64)
    return CSR(indptr, c[order], v[order], (n_pad, n_pad)), bs, n_pad, emb


def _vbilu_apply(n_pad, inner_fn, state, r):
    """Scatter r into the padded space, the uniform-block apply, gather back."""
    inner_state, emb = state
    rp = r.new_zeros((n_pad,) + tuple(r.shape[1:]))
    rp[emb] = r
    return inner_fn(inner_state, rp)[emb]


def _setup_vbilu(A, opts, device, variant: str):
    if opts.block_sizes is None:
        raise ValueError("vbiluk/vbilut need PCOptions.block_sizes "
                         "(reference s.blk_size[], pc-vbiluk.cxx:26-34)")
    Ap, bs, n_pad, emb = vb_embed_matrix(A, opts.block_sizes)
    B = csr_to_bsr(Ap, bs)
    if variant == "vbiluk":
        factors = biluk_factor_bsr(B, level=opts.iluk_level)
    else:
        factors = bilut_factor_bsr(B, tol=opts.ilut_tol, p=opts.ilut_p)
    inner = pack_bilu_pc(factors, variant, opts.ilu_sweeps, device)
    return Preconditioner(functools.partial(_vbilu_apply, n_pad, inner.apply_fn),
                          state=(inner.state, torch.from_numpy(emb).to(device)),
                          name=inner.name)


@register_pc("vbiluk")
def setup_vbiluk(A, opts, device):
    """Variable-block ILU(k) on ``PCOptions.block_sizes``."""
    return _setup_vbilu(A, opts, device, "vbiluk")


@register_pc("vbilut")
def setup_vbilut(A, opts, device):
    """Variable-block ILUT on ``PCOptions.block_sizes``."""
    return _setup_vbilu(A, opts, device, "vbilut")
