"""The two CUDA kernels of lssp_tpu_torch on the card, against their plain
PyTorch versions.  Every test skips without a CUDA device.  This file
imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are relative to max|ref|: 1e-5 in fp32 and 1e-12 in fp64 (the
kernel fuses multiply-adds and sums in its own order)."""
import numpy as np
import pytest
import torch

import lssp_tpu_torch as lt
from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                        plan_fused_neumann)
from lssp_tpu_torch.pc.ilu_host import iluk_factor

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen,N", [("laplacian_2d", 37), ("laplacian_3d", 11),
                                   ("convection_diffusion_2d", 50)])
def test_dia_spmv_matches_plain(cuda, gen, N, dtype):
    A = getattr(lt.sparse, gen)(N)
    D = lt.sparse.csr_to_dia(A, device=cuda).to(dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(N)
    x = torch.rand(A.shape[0], generator=g, dtype=dtype).to(cuda)
    z = torch.rand(A.shape[0], generator=g, dtype=dtype).to(cuda)
    before = dia_spmv.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        y = dia_spmv(D, x, alpha=alpha, beta=beta, z=zz)
        ref = dia_spmv_plain(D.data, D.offsets, x, alpha, beta, zz)
        torch.cuda.synchronize()
        assert y.dtype == dtype and _rel(y, ref) <= TOL[dtype]
    assert dia_spmv.launches == before + 3


def test_dia_spmv_rejects_what_it_cannot_take(cuda):
    D = lt.sparse.csr_to_dia(lt.sparse.laplacian_2d(8), device=cuda)
    x = torch.ones(64, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        dia_spmv(D.to(dtype=torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        dia_spmv(D, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(D, torch.ones(128, dtype=torch.float64, device=cuda)[::2])
    with pytest.raises(ValueError, match="shape"):
        dia_spmv(D, torch.ones(63, dtype=torch.float64, device=cuda))


def _strayed(n1d, nstray):
    import scipy.sparse as sp
    A = lt.sparse.laplacian_2d(n1d)
    rng = np.random.default_rng(0)
    n = A.shape[0]
    r, c = rng.integers(0, n, nstray), rng.integers(0, n, nstray)
    keep = r != c
    E = sp.coo_matrix((0.1 * rng.standard_normal(keep.sum()), (r[keep], c[keep])),
                      shape=A.shape)
    M = (A.to_scipy() + E.tocsr()).tocsr()
    M.sort_indices()
    return lt.CSR.from_scipy(M)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,sweeps", [("banded", 1), ("banded", 6), ("strayed", 4)])
def test_neumann_apply_matches_plain(cuda, kind, sweeps, dtype):
    A = lt.sparse.laplacian_3d(12) if kind == "banded" else _strayed(45, 300)
    L, U = iluk_factor(A, level=0 if kind == "banded" else 1)
    plan = plan_fused_neumann(L, U, sweeps, dtype=dtype, device=cuda)
    assert (plan.L.stray_ptr is not None or plan.U.stray_ptr is not None) == (kind == "strayed")
    r = torch.from_numpy(np.random.default_rng(sweeps).standard_normal(A.shape[0]))
    r = r.to(device=cuda, dtype=dtype)
    before = fused_neumann_apply.launches
    z = fused_neumann_apply(plan, r)
    ref = neumann_apply_plain(plan, r)
    torch.cuda.synchronize()
    assert _rel(z, ref) <= TOL[dtype]
    assert fused_neumann_apply.launches == before + 2 * sweeps


def test_neumann_apply_rejects_dtype_mismatch(cuda):
    L, U = iluk_factor(lt.sparse.laplacian_2d(8), level=0)
    plan = plan_fused_neumann(L, U, 2, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="plan"):
        fused_neumann_apply(plan, torch.ones(64, dtype=torch.float64, device=cuda))


def test_solve_on_cuda_goes_through_both_kernels(cuda):
    A = lt.sparse.laplacian_3d(16)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    k1, k2 = dia_spmv.launches, fused_neumann_apply.launches
    x, info = lt.solve(A, b.to(cuda), method="cg", pc="ilu0")
    assert info.converged
    assert dia_spmv.launches > k1 and fused_neumann_apply.launches > k2
    xc, ic = lt.solve(A, b, method="cg", pc="ilu0", pc_options=lt.PCOptions(ilu_sweeps=6))
    assert abs(info.nits - ic.nits) <= 1
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-8 * torch.linalg.vector_norm(xc)
