"""qmrcgstab, tfqmr, orthomin and bicgstabl of lssp_tpu_torch against
lssp_tpu on the CPU.

Tolerances (``test_torch_krylov_common``): counts JAX's ±1 and x to 1e-8
relative on ``laplacian_2d(32)`` with none / iluk / ilut (ILU exact), also
for BiCGSTAB(l) with l = 1, 2, 4 and ORTHOMIN(k) with k = 1, 5; every
ratchet key at N=32 and N=100 held to recorded + max(2, 5 %); the
per-column batched form's counts JAX's ±1 per column; ``solve_ir`` /
``solve_ir_multi`` totals and the 8-shard ``dist_solve`` counts of tfqmr
JAX's ±2.
"""
import pytest

from test_torch_krylov_common import (batched, distributed, mesh8, parity, pcs,  # noqa: F401
                                      ratchet_100, refinement)

METHODS = ["qmrcgstab", "tfqmr", "orthomin", "bicgstabl"]
CASES = [(m, p) for m in METHODS for p in pcs(m)]


@pytest.mark.parametrize("method,pc", CASES, ids=[f"{m}+{p}" for m, p in CASES])
def test_matches_jax_solve(method, pc):
    parity(method, pc)


@pytest.mark.parametrize("method,pc", CASES, ids=[f"{m}+{p}@100" for m, p in CASES])
def test_ratchet_100(method, pc):
    ratchet_100(method, pc)


@pytest.mark.parametrize("method", METHODS)
def test_batched_matches_jax_vmap(method):
    batched(method)


KNOBS = [("bicgstabl", "none", dict(bgsl=l)) for l in (1, 2, 4)] \
    + [("orthomin", "iluk", dict(restart=k)) for k in (1, 5)]


@pytest.mark.parametrize("method,pc,kw", KNOBS,
                         ids=[f"{m}-{next(iter(kw.items()))}" for m, _, kw in KNOBS])
def test_option_knobs_match_jax(method, pc, kw):
    parity(method, pc, **kw)


def test_bicgstabl_batched_degree_2():
    batched("bicgstabl", bgsl=2)


def test_tfqmr_refinement_matches_jax():
    refinement("tfqmr")


def test_tfqmr_dist_solve_matches_jax(mesh8):  # noqa: F811
    distributed("tfqmr", mesh8)
