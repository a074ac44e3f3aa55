"""Carry state from the JAX package across, as numpy arrays.

Each function takes the fields of an ``lssp_tpu`` container (after
``np.asarray``) and builds the matching container here; the AMG hierarchies
(``amg_from_jax``, ``sa_from_jax``, ``rs_from_jax``) are read attribute by
attribute, every array copied through numpy.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from lssp_tpu_torch.parallel.partition import DistDIA, DistELL, DistHYB
from lssp_tpu_torch.sparse.convert import hyb_from_parts
from lssp_tpu_torch.sparse.types import CSR, DIA, ELL, HYB


def csr_from_arrays(indptr, indices, data, shape) -> CSR:
    """A host CSR from ``lssp_tpu.sparse.CSR`` fields."""
    return CSR(np.asarray(indptr, dtype=np.int32), np.asarray(indices, dtype=np.int32),
               np.asarray(data), (int(shape[0]), int(shape[1])))


def dia_from_arrays(offsets, data, shape, device="cpu") -> DIA:
    """A DIA on ``device`` from ``lssp_tpu.sparse.DIA`` fields (offsets, the
    (ndiag, n) data, shape)."""
    return DIA(tuple(int(o) for o in offsets),
               torch.from_numpy(np.ascontiguousarray(data)).to(device),
               (int(shape[0]), int(shape[1])))


def hyb_from_arrays(offsets, data, rem_rows, rem_cols, rem_vals, shape,
                    device="cpu") -> HYB:
    """A HYB on ``device`` from ``lssp_tpu.sparse.HYB`` fields: the band's
    offsets and (ndiag, n) data, and the remainder triplets.  The trailing
    (n−1, 0, 0.0) entries the JAX package pads the remainder with are
    dropped; its TPU remainder layouts (``win_*``, ``ovr_*``, ``tc_*``) are
    not read."""
    n = int(shape[0])
    r, c, v = np.asarray(rem_rows), np.asarray(rem_cols), np.asarray(rem_vals)
    real = np.flatnonzero((r != n - 1) | (c != 0) | (v != 0))
    k = int(real[-1]) + 1 if len(real) else 0
    return hyb_from_parts(dia_from_arrays(offsets, data, shape, device=device),
                          r[:k], c[:k], v[:k], shape)


def ilu_factors_from_arrays(L_arrays, U_arrays):
    """(L, U) host factors from ``(indptr, indices, data, shape)`` tuples of
    the JAX package's ILU factors (L strictly lower, U upper with the
    diagonal)."""
    return csr_from_arrays(*L_arrays), csr_from_arrays(*U_arrays)


def _t(a, device, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def dist_dia_from_arrays(data, offsets, n, nshards, device="cpu") -> DistDIA:
    """A DistDIA on ``device`` from ``lssp_tpu.parallel.DistDIA`` fields: the
    (P, ndiag, R) data, the offsets, n and P."""
    return DistDIA(_t(data, device), tuple(int(o) for o in offsets), int(n), int(nshards))


def dist_hyb_from_arrays(band_data, offsets, n, nshards, rem_rows, rem_cols, rem_vals,
                         device="cpu") -> DistHYB:
    """A DistHYB on ``device`` from ``lssp_tpu.parallel.DistHYB`` fields: the
    band's (P, ndiag, R) data and offsets, n, P, and the (P, nrem)
    remainder triplets (local rows, global columns; the (0, 0, 0.0)
    padding is kept)."""
    return DistHYB(dist_dia_from_arrays(band_data, offsets, n, nshards, device),
                   _t(rem_rows, device, np.int64), _t(rem_cols, device, np.int64),
                   _t(rem_vals, device))


def dist_ell_from_arrays(cols, data, n, nshards, halo, mode, device="cpu") -> DistELL:
    """A DistELL on ``device`` from ``lssp_tpu.parallel.DistELL`` fields."""
    return DistELL(_t(cols, device, np.int64), _t(data, device), int(n), int(nshards),
                   int(halo), str(mode))


def ell_from_arrays(cols, data, shape, device="cpu") -> ELL:
    """An ELL on ``device`` from ``lssp_tpu.sparse.ELL`` fields."""
    return ELL(_t(cols, device, np.int64), _t(data, device), (int(shape[0]), int(shape[1])))


def matrix_from_jax(M, device="cpu"):
    """A port DIA, HYB or ELL from the JAX container of the same name (None
    stays None)."""
    if M is None:
        return None
    kind = type(M).__name__
    if kind == "DIA":
        return dia_from_arrays(M.offsets, np.array(M.data), M.shape, device)
    if kind == "ELL":
        return ell_from_arrays(np.asarray(M.cols), np.asarray(M.data), M.shape, device)
    if kind == "HYB":
        return hyb_from_arrays(M.dia.offsets, np.array(M.dia.data), np.asarray(M.rem_rows),
                               np.asarray(M.rem_cols), np.asarray(M.rem_vals), M.shape,
                               device)
    raise TypeError(f"no port counterpart for a JAX {kind}")


def amg_from_jax(h, device="cpu"):
    """The port's ``DeviceAMG`` from JAX's (``lssp_tpu.amg.cycle``)."""
    from lssp_tpu_torch.amg.cycle import DeviceAMG, DeviceLevel
    levels = tuple(DeviceLevel(A=matrix_from_jax(l.A, device), P=matrix_from_jax(l.P, device),
                               R=matrix_from_jax(l.R, device), dinv=_t(l.dinv, device),
                               lmax=float(l.lmax), smoother=l.smoother, degree=int(l.degree),
                               omega=float(l.omega))
                   for l in h.levels)
    return DeviceAMG(levels=levels, coarse_inv=_t(h.coarse_inv, device), cycles=int(h.cycles),
                     gamma=int(h.gamma))


def sa_from_jax(h, device="cpu"):
    """The port's ``SAHierarchy`` from JAX's (``lssp_tpu.amg.sa``)."""
    from lssp_tpu_torch.amg.sa import SAHierarchy, SALevel
    levels = tuple(SALevel(
        A=matrix_from_jax(l.A, device), B=matrix_from_jax(l.B, device),
        C=matrix_from_jax(l.C, device), dinv=_t(l.dinv, device), lmax=float(l.lmax),
        g=int(l.g), smoother=l.smoother, degree=int(l.degree), n_next=int(l.n_next),
        agg=l.agg, tri=None if l.tri is None else tuple(_t(a, device) for a in l.tri))
        for l in h.levels)
    return SAHierarchy(levels=levels, coarse_inv=_t(h.coarse_inv, device), n_top=int(h.n_top),
                       gamma=int(h.gamma))


def rs_from_jax(h, device="cpu"):
    """The port's ``RSAMG`` from JAX's (``lssp_tpu.amg.rs``)."""
    from lssp_tpu_torch.amg.rs import RSAMG, AggP, RSLevel
    levels = tuple(RSLevel(
        A=matrix_from_jax(l.A, device),
        P=AggP(offsets=tuple(int(o) for o in l.P.offsets), data=_t(l.P.data, device),
               g=int(l.P.g), agg=l.P.agg, shape=tuple(int(v) for v in l.P.shape)),
        dinv=_t(l.dinv, device), lmax=float(l.lmax), smoother=l.smoother,
        degree=int(l.degree), g=int(l.g))
        for l in h.levels)
    return RSAMG(levels=levels, coarse_inv=_t(h.coarse_inv, device), cycles=int(h.cycles),
                 n_top=int(h.n_top), gamma=int(h.gamma))


def splu_from_jax(L_arrays, U_arrays, perm_in, perm_out, nclamped=0):
    """The port's host ``SpLU`` from the fields of JAX's
    (``lssp_tpu.pc.lu_host.SpLU``): L and U as ``(indptr, indices, data,
    shape)`` tuples, the two permutations and the clamp count."""
    from lssp_tpu_torch.pc.lu_host import SpLU
    return SpLU(L=csr_from_arrays(*L_arrays), U=csr_from_arrays(*U_arrays),
                perm_in=np.asarray(perm_in, np.int32), perm_out=np.asarray(perm_out, np.int32),
                nclamped=int(nclamped))


def arms_from_jax(levels, coarse, dtype=np.float64, device="cpu"):
    """The port's ARMS apply state from JAX's: ``levels`` one ``(f_idx,
    c_idx, invd, E, F)`` per level with E and F as ``(cols, data, shape)``
    ELL fields, and ``coarse`` the coarsest level's ``SpLU`` (the port's,
    e.g. from ``splu_from_jax``), scheduled in ``dtype`` on ``device``."""
    from lssp_tpu_torch.pc.lu import lu_state
    lv = [(_t(f, device, np.int64), _t(c, device, np.int64), _t(d, device),
           ell_from_arrays(*E, device=device), ell_from_arrays(*F, device=device))
          for f, c, d, E, F in levels]
    return lv, lu_state(coarse, np.dtype(dtype), device)
