"""The AMG preconditioners (``lssp_tpu/pc/amg.py``): one cycle an apply.

``amg`` is the classical hierarchy (``amg_setup`` → ``build_device_amg`` →
``vcycle``), the JAX package's route off the TPU; its TPU branch (rsamg or
saamg by lattice detection, ``amg_force_classical``) is not taken, so that
option is accepted and has no effect here.  ``saamg`` and ``rsamg`` are the
structured cycles of ``amg/sa.py`` and ``amg/rs.py``.
"""
from __future__ import annotations

import numpy as np

from lssp_tpu_torch.amg.cycle import build_device_amg, vcycle
from lssp_tpu_torch.amg.rs import setup_rs_pc
from lssp_tpu_torch.amg.sa import setup_saamg_pc
from lssp_tpu_torch.amg.setup import amg_setup
from lssp_tpu_torch.config import smoother_degree
from lssp_tpu_torch.pc.base import Preconditioner, register_pc


def _amg_apply(state, r):
    return vcycle(state, r)


@register_pc("amg")
def setup_amg(A, opts, device):
    hier = amg_setup(A, theta=opts.amg_theta, max_levels=opts.amg_max_levels,
                     coarse_size=opts.amg_coarse_size, smooth_interp=opts.amg_smooth_interp,
                     trunc=opts.amg_trunc)
    h = build_device_amg(
        hier, dtype=np.asarray(A.data).dtype, smoother=opts.amg_smoother,
        degree=smoother_degree(opts.amg_presmooth, opts.amg_postsmooth),
        cycles=opts.amg_cycles, gamma=2 if str(opts.amg_cycle_type).upper() == "W" else 1,
        device=device)
    return Preconditioner(_amg_apply, state=h, name="amg")


@register_pc("saamg")
def setup_saamg(A, opts, device):
    """Structured smoothed-aggregation AMG (``amg/sa.py``)."""
    return setup_saamg_pc(A, opts, device=device)


@register_pc("rsamg")
def setup_rsamg(A, opts, device):
    """Classical AMG with aggregated-diagonal transfers (``amg/rs.py``)."""
    return setup_rs_pc(A, opts, device=device)
