"""bicgsafe, bicrsafe, gpbicg and gpbicr of lssp_tpu_torch against lssp_tpu on the CPU.

Tolerances (``test_torch_krylov_common``): counts JAX's ±1 and x to 1e-8
relative on ``laplacian_2d(32)`` with none / iluk / ilut (ILU exact);
every ratchet key at N=32 and N=100 held to recorded + max(2, 5 %), the
golden NaN-x class (``bicgsafe+ilut@100``, ``bicrsafe+ilut@100``: the
reference's x overflowed) as ``tests/test_solvers.py`` holds it, converged
with a finite x and a small true residual; the
per-column batched form's counts JAX's ±1 per column.
"""
import pytest

from test_torch_krylov_common import batched, parity, pcs, ratchet_100

METHODS = ["bicgsafe", "bicrsafe", "gpbicg", "gpbicr"]
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
