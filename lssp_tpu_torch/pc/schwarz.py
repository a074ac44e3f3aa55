"""Restricted additive Schwarz (RAS): ``ras``, ``schwarz`` and ``bjacobi``
(the reference's FASP and PETSc adapter capabilities,
solver-fasp.cxx:161-193, solver-petsc.cxx:23-32; ``lssp_tpu/pc/
schwarz.py``).  The subdomains are B contiguous row ranges of bs rows,
each widened by ``overlap`` rows on both sides to a window of E = bs + 2o
rows; each window's ILU(k) factors go into one block-diagonal L and U
over the B·E stacked rows, so that the local solves are one
``make_ilu_pc`` apply: exact level schedules, or one K2 launch (K2k on a
block) over all windows on the card.  The apply gathers every window of
the zero-padded r in one indexing (r (n,) or an (n, k) block), applies
the local solve, and keeps each window's owned rows (the restricted
update).  ``bjacobi`` is RAS with no overlap.  As in JAX, no M⁻ᵀ apply
is installed."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from lssp_tpu_torch.pc.base import Preconditioner, register_pc
from lssp_tpu_torch.pc.ilu import make_ilu_pc
from lssp_tpu_torch.pc.ilu_host import iluk_factor
from lssp_tpu_torch.sparse.types import CSR


def _extract_window(ip, idx, dat, lo: int, hi: int, E: int, at: int) -> CSR:
    """Rows and columns [lo, hi) of the CSR (ip, idx, dat) placed at offset
    ``at`` of an (E, E) block whose other diagonal entries are 1
    (decoupled padding)."""
    rows = np.repeat(np.arange(lo, hi, dtype=np.int64), ip[lo + 1:hi + 1] - ip[lo:hi])
    sl = slice(ip[lo], ip[hi])
    keep = (idx[sl] >= lo) & (idx[sl] < hi)
    padr = np.setdiff1d(np.arange(E, dtype=np.int64),
                        np.arange(at, at + hi - lo, dtype=np.int64))
    r = np.concatenate([rows[keep] - lo + at, padr])
    c = np.concatenate([idx[sl][keep] - lo + at, padr])
    v = np.concatenate([dat[sl][keep], np.ones(len(padr), dtype=dat.dtype)])
    order = np.lexsort((c, r))
    p = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=E))])
    return CSR(p.astype(np.int64), c[order].astype(np.int64), v[order], (E, E))


def _block_diag_csr(blocks):
    """(E, E) CSR blocks stacked into one block-diagonal CSR."""
    E, B = blocks[0].shape[0], len(blocks)
    ips = [np.asarray(blk.indptr, np.int64) for blk in blocks]
    offs = np.concatenate([[0], np.cumsum([int(ip[-1]) for ip in ips])])
    indptr = np.concatenate([ips[i][:-1] + offs[i] for i in range(B)] + [[offs[-1]]])
    indices = (np.concatenate([np.asarray(blk.indices, np.int64) + i * E
                               for i, blk in enumerate(blocks)]) if offs[-1]
               else np.zeros(0, np.int64))
    data = (np.concatenate([np.asarray(blk.data) for blk in blocks]) if offs[-1]
            else np.zeros(0))
    return CSR(indptr, indices, data, (B * E, B * E))


@dataclasses.dataclass(frozen=True)
class _Windows:
    """The window layout: B windows of bs owned rows and o overlap rows a
    side over n rows; ``index`` (B·E,) the row of the padded r each
    stacked row reads (window i starts at row i·bs of r padded by o)."""

    B: int
    bs: int
    o: int
    n: int
    index: torch.Tensor


def _ras_apply(inner_apply_fn, win, state, r):
    tail = tuple(r.shape[1:])
    npad = win.B * win.bs - win.n
    rp = F.pad(r, (0, 0, win.o, win.o + npad) if tail else (win.o, win.o + npad))
    z = inner_apply_fn(state, rp[win.index])
    owned = z.view((win.B, win.bs + 2 * win.o) + tail)[:, win.o:win.o + win.bs]
    return owned.reshape((win.B * win.bs,) + tail)[:win.n]      # the restricted update


@register_pc("ras")
def setup_ras(A, opts, device):
    n = A.shape[0]
    B = int(opts.num_blocks) if opts.num_blocks else max(2, -(-n // 4096))
    o = int(opts.schwarz_overlap)
    bs = -(-n // B)
    E = bs + 2 * o
    # int64 copies of the structure once, not once a window
    csr = (np.asarray(A.indptr).astype(np.int64), np.asarray(A.indices).astype(np.int64),
           np.asarray(A.data))
    Ls, Us = [], []
    for i in range(B):
        lo, hi = max(0, i * bs - o), min(n, (i + 1) * bs + o)
        blk = _extract_window(*csr, lo, hi, E, lo - (i * bs - o))   # clipped at the edges
        L, U = iluk_factor(blk, level=opts.iluk_level)
        Ls.append(L)
        Us.append(U)
    inner = make_ilu_pc(_block_diag_csr(Ls), _block_diag_csr(Us), "ras-local",
                        opts.ilu_sweeps, device=device)
    index = (torch.arange(B, device=device)[:, None] * bs
             + torch.arange(E, device=device)[None, :]).reshape(-1)
    win = _Windows(B, bs, o, n, index)
    return Preconditioner(functools.partial(_ras_apply, inner.apply_fn, win),
                          state=inner.state, name=f"ras(B={B},o={o})")


register_pc("schwarz")(setup_ras)


@register_pc("bjacobi")
def setup_bjacobi(A, opts, device):
    """Block Jacobi with ILU local solves (the PETSc adapter's BJACOBI,
    solver-petsc.cxx:23-32): RAS with no overlap."""
    return setup_ras(A, dataclasses.replace(opts, schwarz_overlap=0), device)
