"""Algebraic multigrid: the classical hierarchy (strength → PMIS → direct
interpolation → Galerkin RAP, ``setup.py``) and its cycle (``cycle.py``),
structured smoothed aggregation (``sa.py``), classical AMG with
gather-free transfers (``rs.py``) and the hierarchical-aggregation ordering
(``aggregate.py``).  The host setups are copies of the JAX package's; the
cycles run on torch tensors (DIA levels through kernel K1 on CUDA)."""

from lssp_tpu_torch.amg.setup import (
    AMGHierarchy, AMGLevel, amg_setup, direct_interpolation, pmis_coarsen, strength_graph,
)
from lssp_tpu_torch.amg.cycle import DeviceAMG, amg_solve, build_device_amg, fmg_initial, vcycle
from lssp_tpu_torch.amg.sa import SAHierarchy, sa_setup, sa_vcycle
from lssp_tpu_torch.amg.rs import RSAMG, build_device_rs, rs_fmg_initial, rs_host_setup, rs_vcycle
from lssp_tpu_torch.amg.aggregate import hierarchy_perm

__all__ = ["amg_setup", "AMGHierarchy", "AMGLevel", "strength_graph", "pmis_coarsen",
           "direct_interpolation", "build_device_amg", "vcycle", "fmg_initial", "amg_solve",
           "DeviceAMG", "SAHierarchy", "sa_setup", "sa_vcycle", "RSAMG", "rs_host_setup",
           "build_device_rs", "rs_vcycle", "rs_fmg_initial", "hierarchy_perm"]
