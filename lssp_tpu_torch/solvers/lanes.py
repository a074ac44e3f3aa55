"""One body for a method's single-rhs form and its per-column batched form.

A *lane* is one right-hand side.  The single-rhs form runs one lane on an
(n,) vector with 0-d tensor scalars; the batched form (``solve_multi``'s
per-column path, JAX's ``jax.vmap``) runs k lanes on an (n, k) block with
(k,) scalars.  The same tensor code serves both: ``base.dot`` and
``base.norm`` reduce over the rows only (a block's column in its
single-rhs order, since BiCRSTAB and QMRCGSTAB amplify a change of
rounding into a change of count), and a (k,) scalar broadcasts over the
block's columns.  ``Lanes`` keeps each lane's count, residual, tolerance
and trace on the host.

Each iteration brings what its stopping test needs to the host in one
read (``Lanes.read``: one stacked transfer, one device sync), breakdown
scalars included, and the host decides per lane.  A lane that stops
(converged, maxit, breakdown) never resumes, so only what it reports (x,
its count and residual) is frozen: ``Lanes.pick`` keeps it, with no
launch when every lane agrees, the single-rhs case always.  The rest of
a stopped lane's recurrence runs on with the others and is never read.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.solvers.base import (
    SolveInfo, dot as base_dot, history_init, history_init_block, history_update,
    history_update_block, norm,
)


def combine(c: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Σ_i c[i]·V[i] for coefficients c (m,) + lane and a basis V (m, n) + lane,
    summed in order of i, one multiply and one add a term: a block's column
    then takes its single-rhs rounding (a GEMV for one lane and a reduction
    for k would not)."""
    if V.shape[0] == 0:
        return V.new_zeros(V.shape[1:])
    c = c.unsqueeze(1)
    out = c[0] * V[0]
    for i in range(1, V.shape[0]):
        out = out + c[i] * V[i]
    return out


class Lanes:
    """The host side of a solve over one lane (b (n,)) or k lanes (b (n, k)).

    ``it``, ``res``, ``tol``, ``active`` are numpy arrays of the lane shape
    (0-d or (k,)).  A lane is active while ``it < limit`` (``maxit``, or
    ``maxit + 1`` for the methods whose JAX loop tests ``it <= maxit``),
    its residual is above its tolerance and it has not broken down.
    ``it0``: the count a lane starts at (tfqmr counts from 1); ``dot``: the
    solve's inner product, for ‖b‖ and ‖r0‖."""

    def __init__(self, b: torch.Tensor, r: torch.Tensor, opts, limit=None, it0: int = 0,
                 dot=base_dot):
        self.opts = opts
        self.single = b.dim() == 1
        self.shape = tuple(b.shape[1:])
        self.device = b.device
        self.limit = opts.maxit if limit is None else limit
        self.bnorm, self.r0norm = self.read(norm(b, dot), norm(r, dot))
        self.tol = np.maximum(np.maximum(opts.rtol * self.r0norm, opts.atol),
                              opts.rbtol * self.bnorm)
        self.it = np.full(self.shape, it0, np.int64)
        self.res = self.r0norm.copy()
        if self.single:
            self.hist = history_init(opts, float(self.r0norm))
        else:
            self.hist = history_init_block(opts, self.shape[0], self.r0norm)
        self.active = (self.it < self.limit) & (self.res > self.tol)
        self.rel = False                    # trace the relative residuals too
        self._mask = (None, None)

    def read(self, *ts: torch.Tensor):
        """The lane values of each tensor (0-d or (k,), one dtype), as fp64
        numpy arrays of the lane shape, in one transfer."""
        host = torch.stack(ts).cpu().numpy().astype(np.float64)
        return tuple(host)

    def scalar(self, value: float, like: torch.Tensor) -> torch.Tensor:
        """A lane scalar (0-d or (k,)) of ``like``'s dtype and device."""
        return torch.full(self.shape, value, dtype=like.dtype, device=like.device)

    def mask(self, cond: np.ndarray) -> torch.Tensor:
        """The host lane mask on the device (one copy per distinct mask)."""
        key = cond.tobytes()
        if self._mask[0] != key:
            self._mask = (key, torch.from_numpy(np.array(cond, bool)).to(self.device))
        return self._mask[1]

    def pick(self, cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a in the lanes where ``cond`` (host) holds, else b."""
        cond = np.asarray(cond, bool)
        if cond.all():
            return a
        if not cond.any():
            return b
        return torch.where(self.mask(cond), a, b)

    def record(self, cols, values=None) -> None:
        """Trace the lanes in ``cols`` at their count: their residual, or
        ``values``."""
        values = self.res if values is None else values
        rel = (self.r0norm, self.bnorm) if self.rel else (None, None)
        if self.single:
            if cols:
                history_update(self.opts, self.hist, int(self.it), float(values), *rel)
        else:
            history_update_block(self.opts, self.hist, self.it, values, *rel, cols=cols)

    def count(self, cols, res, trace=None) -> None:
        """One iteration of the lanes in ``cols``, with residuals ``res``
        (``trace``: the value to trace in their place, if another)."""
        cols = np.asarray(cols, bool)
        self.it = self.it + cols
        self.res = np.where(cols, res, self.res)
        self.record(cols, trace)

    def settle(self, done=False) -> None:
        """Drop the lanes that broke down (``done``), converged or ran out."""
        self.active = (self.active & ~np.asarray(done, bool) & (self.res > self.tol)
                       & (self.it < self.limit))

    def advance(self, res, done=False, trace=None) -> None:
        """The end of one iteration of every active lane."""
        self.count(self.active, res, trace)
        self.settle(done)

    def result(self, x: torch.Tensor, residual=None, converged=None, r0norm=None):
        """(x, SolveInfo): Python scalars for one lane, (k,) arrays for k."""
        res = self.res if residual is None else residual
        conv = res <= self.tol if converged is None else converged
        r0 = self.r0norm if r0norm is None else r0norm
        if self.single:
            return x, SolveInfo(nits=int(self.it), residual=float(res), converged=bool(conv),
                                r0norm=float(r0), bnorm=float(self.bnorm), history=self.hist)
        return x, SolveInfo(nits=self.it, residual=np.asarray(res, np.float64),
                            converged=np.asarray(conv, bool), r0norm=r0, bnorm=self.bnorm,
                            history=self.hist)
