"""IDR(s) (reference lssp_solver_idrs, solver-idrs.cxx:86-283): the
s-dimensional shadow space P of orthonormalized random vectors (:139-144),
s warm-up minimal-residual steps that build dX, dR and the s×s matrix
M = Pᵀ·dR, then the IDR recurrence with ω recomputed every (s+1)-th step
(:190-215).  The small system M·c = m is a dense LU on the device.  As in
JAX the main loop runs while it ≤ maxit, and the warm-up runs its s steps
whatever maxit and the residual (a lane that converges there stops).

P is JAX's (``lssp_tpu/solvers/idrs.py:34-44``): ``jax.random.uniform(
PRNGKey(0), (s, n), dtype)``, reproduced bit for bit by ``_threefry``
and orthonormalized by MGS.  Under the distributed solve JAX draws it per
shard, inside its ``shard_map``, as (s, R) orthonormalized shard by shard;
an operator with ``shards`` gets that P tiled across its shards.

One body for the single-rhs and the per-column batched form (``lanes``);
every column shares P, as under JAX's ``vmap``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from lssp_tpu_torch.solvers import _threefry
from lssp_tpu_torch.solvers.base import dot as base_dot, dot_rows, init_state, nonzero, norm
from lssp_tpu_torch.solvers.lanes import Lanes, combine
from lssp_tpu_torch.solvers.registry import register_batched, register_solver

_SHADOW: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_SHADOW_SLOTS = 4


def shadow_space(s: int, n: int, dtype: torch.dtype, device, shards: int = 1) -> torch.Tensor:
    """The (s, n) shadow space: JAX's uniform draw of (s, n / shards),
    orthonormalized by MGS (idrs_orth, reference :4-21) and tiled over
    ``shards``.  Memoized (LRU) per shape, dtype and device."""
    key = (s, n, dtype, str(device), shards)
    if key in _SHADOW:
        _SHADOW.move_to_end(key)
        return _SHADOW[key]
    P = _threefry.uniform((s, n // shards), dtype, device)
    for j in range(s):
        pj = P[j] / torch.sqrt(base_dot(P[j], P[j]))
        P[j] = pj
        for i in range(j + 1, s):
            P[i] = P[i] - base_dot(pj, P[i]) * pj
    if shards > 1:
        P = P.repeat(1, shards)
    _SHADOW[key] = P
    if len(_SHADOW) > _SHADOW_SLOTS:
        _SHADOW.popitem(last=False)
    return P


def _project(P: torch.Tensor, v: torch.Tensor, dot) -> torch.Tensor:
    """P·v, (s,) + lane: the s inner products of ``dot_rows`` (on the CPU
    in ``base.dot``'s order, which no thread count changes; on a mesh one
    reduction over the shards), or one GEMV on CUDA for ``base.dot``."""
    if dot is base_dot and v.device.type != "cpu":
        return P @ v
    return dot_rows(dot, P.reshape(P.shape + (1,) * (v.dim() - 1)), v)


def _small_solve(G: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """G c = m for G (s, s) + lane, without a device sync."""
    if G.dim() == 2:
        return torch.linalg.solve_ex(G, m)[0]
    return torch.linalg.solve_ex(G.permute(2, 0, 1), m.T)[0].T


@register_batched("idrs")
@register_solver("idrs")
def idrs(A, b, x0=None, M=None, opts=None, dot=base_dot):
    s = opts.idrs
    op, pc, x, r = init_state(A, b, x0, M)
    L = Lanes(b, r, opts, limit=opts.maxit + 1, dot=dot)
    P = shadow_space(s, b.shape[0], b.dtype, b.device, getattr(A, "shards", 1))
    dX = b.new_zeros((s,) + tuple(b.shape))
    dR = torch.zeros_like(dX)
    lane = L.shape
    G = torch.eye(s, dtype=b.dtype, device=b.device).reshape((s, s) + (1,) * len(lane))
    G = G.repeat((1, 1) + lane)
    stopped = np.zeros(lane, bool)
    for k in range(s):                      # warm-up (:148-171)
        dx = pc(r)
        dr = op(dx)
        om = dot(dr, r) / nonzero(dot(dr, dr))
        dx = om * dx
        dr = -om * dr
        go = ~stopped
        x = L.pick(go, x + dx, x)
        r = r + dr
        dX[k], dR[k] = dx, dr
        (res,) = L.read(norm(r, dot))
        L.it = np.where(go, k + 1, L.it)
        L.res = np.where(go, res, L.res)
        L.record(go)
        G[:, k] = _project(P, dr, dot)
        stopped = stopped | (L.res <= L.tol)
        if stopped.all():
            break
    L.active = (L.it < L.limit) & (L.res > L.tol)
    m = _project(P, r, dot)
    oldest = 0
    while L.active.any():
        c = _small_solve(G, m)
        v = r - combine(c, dR)
        av = pc(v)
        if int(L.it[L.active][0]) % (s + 1) == s:     # every active lane has one count
            t = op(av)
            om = dot(t, v) / nonzero(dot(t, t))
            dx = om * av - combine(c, dX)
            dr = -om * t - combine(c, dR)
        else:
            dx = om * av - combine(c, dX)
            dr = -op(dx)
        r = r + dr
        x = L.pick(L.active, x + dx, x)
        dX[oldest], dR[oldest] = dx, dr
        (res,) = L.read(norm(r, dot))
        L.advance(res)
        h = _project(P, dr, dot)
        m = m + h
        G[:, oldest] = h
        oldest = (oldest + 1) % s
    return L.result(x)
