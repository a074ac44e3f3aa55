"""K1's plain version and the SpMV family against lssp_tpu on the CPU.

On CPU tensors ``dia_spmv`` runs ``dia_spmv_plain``; it must match the JAX
``spmv`` and the Pallas kernel ``dia_spmv_pallas`` run with
``interpret=True``.  Tolerances are relative to max|y|: 1e-5 in fp32 (the
Pallas kernel sums in another order), 1e-12 in fp64.  CSR/ELL gathers and
the mvops wrappers are held against scipy in fp64.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.ops.pallas_spmv import dia_spmv_pallas
from lssp_tpu.ops.spmv import spmv as jspmv
import lssp_tpu_torch as T
from lssp_tpu_torch.ops import dia_spmv, dia_spmv_plain, mv_amxpby, mv_amxpbyz, mv_amxy, mv_mxy, spmv

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CASES = [("laplacian_2d", 21), ("laplacian_2d", 64), ("laplacian_3d", 8)]   # n = 441, 4096, 512


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("gen,N", CASES, ids=[f"{g}({N})" for g, N in CASES])
def test_dia_plain_matches_jax_and_pallas(gen, N, dtype, scale):
    Aj = getattr(J.sparse, gen)(N)
    At = getattr(T.sparse, gen)(N)
    Dj = J.sparse.csr_to_dia(Aj)
    Dj = dataclasses.replace(Dj, data=np.asarray(Dj.data, dtype))
    Dt = T.sparse.csr_to_dia(At, dtype=dtype)
    x = np.random.default_rng(N).standard_normal(Aj.shape[0]).astype(dtype)
    y = mv_amxy(scale, Dt, torch.from_numpy(x))
    assert y.dtype == Dt.dtype and y.shape == (Aj.shape[0],)
    y_pallas = dia_spmv_pallas(Dj, jnp.asarray(x), interpret=True, scale=scale)
    y_jax = scale * jspmv(Dj, jnp.asarray(x))
    assert _rel(y.numpy(), y_pallas) <= TOL[dtype]
    assert _rel(y.numpy(), y_jax) <= TOL[dtype]
    assert _rel(y.numpy(), scale * (At.to_scipy() @ x.astype(np.float64))) <= TOL[dtype]


def test_dia_epilogue_and_mvops():
    """alpha/beta epilogue (mv_amxpby) and the other mvops, DIA, against scipy."""
    A = T.sparse.convection_diffusion_2d(9)
    D = T.sparse.csr_to_dia(A)
    rng = np.random.default_rng(0)
    x, z = rng.standard_normal(81), rng.standard_normal(81)
    S = A.to_scipy()
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    np.testing.assert_allclose(mv_amxpby(-1.5, D, xt, 0.5, zt).numpy(),
                               0.5 * z - 1.5 * (S @ x), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(mv_amxpbyz(2.0, D, xt, -1.0, zt).numpy(),
                               -z + 2.0 * (S @ x), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(mv_mxy(D, xt).numpy(), S @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(dia_spmv(D, xt, alpha=-1.0, beta=1.0, z=zt).numpy(),
                               z - S @ x, rtol=1e-13, atol=1e-13)
    assert dia_spmv.launches == 0       # CPU tensors never launch the kernel


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_gather_formats_match_scipy(fmt):
    A = T.sparse.random_sparse(120, nnz_per_row=7, seed=9)
    M = A.to("cpu") if fmt == "csr" else T.sparse.csr_to_ell(A)
    x = np.random.default_rng(1).standard_normal(120)
    xt = torch.from_numpy(x)
    S = A.to_scipy()
    np.testing.assert_allclose(spmv(M, xt).numpy(), S @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mv_amxy(0.25, M, xt).numpy(), 0.25 * (S @ x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mv_amxpby(2.0, M, xt, -0.5, xt).numpy(),
                               -0.5 * x + 2.0 * (S @ x), rtol=1e-12, atol=1e-12)


def test_spmv_rejects_host_csr_and_unknown_types():
    A = T.sparse.laplacian_2d(4)
    with pytest.raises(TypeError, match="CSR.to"):
        spmv(A, torch.ones(16, dtype=torch.float64))
    with pytest.raises(TypeError, match="unsupported"):
        spmv(np.eye(3), torch.ones(3))
    assert torch.equal(spmv(lambda v: 2 * v, torch.ones(3)), 2 * torch.ones(3))


def test_dia_plain_rectangular_and_empty_offsets():
    """Rows whose diagonals run off the right edge of a wide matrix read
    zeros; a DIA with no diagonals yields zeros."""
    data = torch.arange(1.0, 7.0, dtype=torch.float64).reshape(2, 3)
    y = dia_spmv_plain(data, (0, 2), torch.arange(1.0, 5.0, dtype=torch.float64))
    # A = [[1, 0, 4, 0], [0, 2, 0, 5], [0, 0, 3, 0]]: row 2's +2 slot (column 4,
    # value 6) lies off the matrix
    assert y.tolist() == [1 * 1 + 4 * 3, 2 * 2 + 5 * 4, 3 * 3]
    assert dia_spmv_plain(torch.zeros(0, 3), (), torch.ones(3)).tolist() == [0, 0, 0]
