"""The distributed multi-rhs path of lssp_tpu_torch (``dist_solve_multi``,
``dist_solve_ir_multi``, K4k's plain version, the block products and
block-Jacobi applies on (P, R, k) blocks) against lssp_tpu on the CPU.

JAX runs on its 8-virtual-device mesh (``tests/conftest.py``); the port
runs the same 8 shards as the leading axis of tensors on one CPU device.
K4k's plain version against the B2 vmap rule (``jax.vmap`` over
``dia_spmv_pallas_ext`` with ``interpret=True``), per shard, to 1e-12
(fp64) / 1e-5 (fp32) of max |ref|.  The block products and PC applies
equal the port's vector path column by column (bitwise for the products,
1e-13 for the exact level schedules).  Solves (tests/test_dist.py
TestDistSolveMulti / TestDistIR without AMG): true relres per column,
per-column counts equal the port's ``dist_solve`` and JAX's ±1, block
counts within JAX's ±2.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops.pallas_spmv import dia_spmv_pallas_ext
from lssp_tpu.parallel import dist_solve as jsolve
import lssp_tpu_torch as T
from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmm_ext_plain
from lssp_tpu_torch.parallel import partition as tpart
from lssp_tpu_torch.parallel.dist_ops import make_dist_spmv
from lssp_tpu_torch.solvers.base import GRAM_CHUNK, chunked_gram

tsolve = importlib.import_module("lssp_tpu_torch.parallel.dist_solve")


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


def cpu_mesh(p=8):
    return T.make_mesh(p, devices=[torch.device("cpu")] * p)


def _block(n, k, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _relres(A, B, X):
    B, X = np.asarray(B), np.asarray(X)
    return np.linalg.norm(B - A.to_scipy() @ X, axis=0) / np.linalg.norm(B, axis=0)


def nearly_banded(n_side=16, n_extra=40, seed=4):
    """TestDistHYB._nearly_banded (tests/test_dist.py)."""
    rng = np.random.default_rng(seed)
    S = J.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] += 0.02
    return T.CSR.from_scipy(S.tocsr())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_dia_spmm_ext_plain_matches_pallas_vmap_rule(dtype, tol):
    """Per shard, K4k's plain version against B2's k-rhs rule; and the
    sweep epilogue (−1, 1, z)."""
    A = T.sparse.convection_diffusion_2d(32, beta=10.0).astype(dtype)
    M = tpart.partition_csr_dia(A, 4)                          # R = 256, lo = hi = 32
    R, lo, hi = M.rows_per_shard, M.lo, M.hi
    rng = np.random.default_rng(7)
    x_ext = rng.standard_normal((4, R + lo + hi, 3)).astype(dtype)
    z = rng.standard_normal((4, R, 3)).astype(dtype)
    y = dia_spmm_ext_plain(M.data, M.offsets, torch.from_numpy(x_ext))
    ys = dia_spmm_ext(M.data, M.offsets, torch.from_numpy(x_ext), -1.0, 1.0,
                      torch.from_numpy(z))                      # CPU: the plain version
    assert y.shape == (4, R, 3) and dia_spmm_ext.launches == 0
    for p in range(4):
        ref = np.asarray(jax.vmap(lambda v: dia_spmv_pallas_ext(
            jnp.asarray(M.data[p].numpy()), v, M.offsets, interpret=True))(
                jnp.asarray(x_ext[p].T))).T
        assert np.abs(y[p].numpy() - ref).max() <= tol * np.abs(ref).max()
        assert np.abs(ys[p].numpy() - (z[p] - ref)).max() <= tol * np.abs(z[p] - ref).max()


PRODUCTS = [("laplacian_2d_16", "dia"), ("nearly_banded", "hyb"), ("laplacian_2d_16", "halo"),
            ("random_sparse_64", "allgather")]


def _matrix(name):
    if name == "nearly_banded":
        return nearly_banded()
    if name == "random_sparse_64":
        S = sp.csr_matrix(J.sparse.random_sparse(64, 6).to_scipy())
        S.sort_indices()
        return T.CSR.from_scipy(S)
    return T.sparse.laplacian_2d(16)


@pytest.mark.parametrize("name,fmt", PRODUCTS)
def test_dist_block_products_equal_the_vector_path(name, fmt):
    A = _matrix(name)
    op = make_dist_spmv(tpart.partition_matrix(A, 8, fmt=fmt))
    X = torch.from_numpy(_block(A.shape[0], 3, 1))
    Y = op(X)
    assert Y.shape == X.shape
    for c in range(3):
        assert torch.equal(Y[:, c], op(X[:, c].contiguous()))
    np.testing.assert_allclose(Y.numpy(), A.to_scipy() @ X.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n", [64, 2 * GRAM_CHUNK, 2 * GRAM_CHUNK + 8 * 37])
def test_psum_gram(n):
    # the Gram a block solver takes over the shard mesh: whole chunks, a
    # tail, or only a tail, at eight shards' worth of rows or any other n
    U, V = (torch.from_numpy(_block(n, k, s)) for k, s in ((5, 2), (3, 3)))
    np.testing.assert_allclose(chunked_gram(U, V).numpy(), U.numpy().T @ V.numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name,pc,sweeps,kind", [("laplacian_2d_16", "bjilu", 6, "ilu_nm"),
                                                 ("laplacian_2d_16", "bjilu", 0, "ilu"),
                                                 ("laplacian_2d_16", "jacobi", None, "jacobi"),
                                                 ("union_buster", "bjilu", 3, "ilu_nmd")])
def test_dist_pc_block_apply(name, pc, sweeps, kind):
    if name == "union_buster":
        from tests.test_torch_dist import union_buster
        A = T.CSR.from_scipy(union_buster())
    else:
        A = T.sparse.laplacian_2d(16)
    R = A.shape[0] // 8
    kt, st = tsolve._build_dist_pc(A, pc, T.PCOptions(ilu_sweeps=sweeps).resolved(), 8, R,
                                   torch.device("cpu"))
    assert kt == kind
    apply = tsolve._shard_pc_apply(kt, st, 8, R)
    X = torch.from_numpy(_block(A.shape[0], 3, 4))
    Z = apply(X)
    assert Z.shape == X.shape
    for c in range(3):
        torch.testing.assert_close(Z[:, c], apply(X[:, c].contiguous()), rtol=1e-13, atol=1e-13)


def test_dist_solve_multi_matches_per_rhs(mesh8):
    """cg + bjilu on 16², k = 3: each column as its own dist_solve."""
    Aj, At = J.sparse.laplacian_2d(16), T.sparse.laplacian_2d(16)
    B = _block(256, 3, 5)
    po = dict(j=J.PCOptions(ilu_sweeps=6), t=T.PCOptions(ilu_sweeps=6))
    _, ij = jsolve.dist_solve_multi(Aj, jnp.asarray(B), method="cg", pc="bjilu", mesh=mesh8,
                                    pc_options=po["j"])
    X, info = T.dist_solve_multi(At, torch.from_numpy(B), method="cg", pc="bjilu",
                                 mesh=cpu_mesh(), pc_options=po["t"])
    assert X.shape == (256, 3) and info.converged.all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 1).all(), (info.nits, ij.nits)
    for c in range(3):
        x, i = T.dist_solve(At, torch.from_numpy(B[:, c]), method="cg", pc="bjilu",
                            mesh=cpu_mesh(), pc_options=po["t"])
        assert info.nits[c] == i.nits
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=1e-10, atol=1e-12)


def test_dist_blockcg_multi(mesh8):
    """Block CG + bjilu on 32², k = 4: true residuals, fewer iterations
    than per-column dist CG, counts within JAX's ±2."""
    Aj, At = J.sparse.laplacian_2d(32), T.sparse.laplacian_2d(32)
    B = _block(1024, 4, 6)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=1000)
    po = dict(j=J.PCOptions(ilu_sweeps=6), t=T.PCOptions(ilu_sweeps=6))
    _, ij = jsolve.dist_solve_multi(Aj, jnp.asarray(B), method="blockcg", pc="bjilu",
                                    mesh=mesh8, options=J.SolverOptions(**o), pc_options=po["j"])
    X, info = T.dist_solve_multi(At, torch.from_numpy(B), method="blockcg", pc="bjilu",
                                 mesh=cpu_mesh(), options=T.SolverOptions(**o),
                                 pc_options=po["t"])
    assert info.converged.all() and (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)
    _, ic = T.dist_solve_multi(At, torch.from_numpy(B), method="cg", pc="bjilu",
                               mesh=cpu_mesh(), options=T.SolverOptions(**o), pc_options=po["t"])
    assert info.nits.max() < ic.nits.min(), (info.nits, ic.nits)


def test_dist_blockgmres_multi(mesh8):
    """Block GMRES + jacobi on convection_diffusion_2d(24), k = 3, restart
    25: true residuals; counts within JAX's ±2 and within one restart of
    the port's single-device block solve."""
    Aj, At = J.sparse.convection_diffusion_2d(24), T.sparse.convection_diffusion_2d(24)
    B = _block(576, 3, 7)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=600, restart=25)
    _, ij = jsolve.dist_solve_multi(Aj, jnp.asarray(B), method="blockgmres", pc="jacobi",
                                    mesh=mesh8, options=J.SolverOptions(**o))
    X, info = T.dist_solve_multi(At, torch.from_numpy(B), method="blockgmres", pc="jacobi",
                                 mesh=cpu_mesh(), options=T.SolverOptions(**o))
    assert info.converged.all() and (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)
    _, i1 = T.solve_multi(At, torch.from_numpy(B), method="blockgmres", pc="jacobi",
                          options=T.SolverOptions(**o))
    assert (np.abs(info.nits - i1.nits) <= o["restart"]).all()


def test_dist_solve_ir_multi_block_inner(mesh8):
    """The default blockgmres inner with bjilu on convection_diffusion_2d(24),
    k = 4 (TestDistIR.test_multi_block_inner)."""
    Aj, At = J.sparse.convection_diffusion_2d(24), T.sparse.convection_diffusion_2d(24)
    B = _block(576, 4, 8)
    o = dict(rtol=1e-8, atol=0.0, maxit=2000, restart=30)
    po = dict(j=J.PCOptions(ilu_sweeps=6), t=T.PCOptions(ilu_sweeps=6))
    _, ij = jsolve.dist_solve_ir_multi(Aj, jnp.asarray(B), pc="bjilu", mesh=mesh8,
                                       options=J.SolverOptions(**o), pc_options=po["j"])
    X, info = T.dist_solve_ir_multi(At, torch.from_numpy(B), pc="bjilu", mesh=cpu_mesh(),
                                    options=T.SolverOptions(**o), pc_options=po["t"])
    assert X.dtype == torch.float64 and info.converged.all()
    assert (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)


def test_dist_solve_ir_multi_blockcg_ilu0():
    """The chip's phase-18 configuration at 16³ with identity padding (n =
    4096 + 0) and k = 3: blockcg + ILU(0) per shard; each column reaches
    1e-8 and its count stays within twice the single-rhs count."""
    A = T.sparse.laplacian_3d(16)
    B = _block(A.shape[0], 3, 9)
    kw = dict(method="blockcg", pc="ilu0", mesh=cpu_mesh(),
              options=T.SolverOptions(rtol=1e-8, atol=0.0, maxit=2000),
              pc_options=T.PCOptions(ilu_sweeps=6))
    X, info = T.dist_solve_ir_multi(A, torch.from_numpy(B), **kw)
    assert info.converged.all() and (_relres(A, B, X) <= 1e-8).all()
    kw["method"] = "cg"
    _, i1 = T.dist_solve_ir(A, torch.from_numpy(B[:, 0]), **kw)
    assert info.nits.max() <= 2 * i1.nits


def test_dist_multi_errors():
    A = T.sparse.laplacian_2d(16)
    with pytest.raises(ValueError, match="dist_solve_ir_multi"):
        T.dist_solve_ir(A, torch.ones(256, dtype=torch.float64), method="blockcg",
                        mesh=cpu_mesh())
    with pytest.raises(ValueError, match="dist_solve_multi"):
        T.dist_solve(A, torch.ones(256, dtype=torch.float64), method="blockgmres",
                     mesh=cpu_mesh())
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        T.dist_solve_multi(A, torch.ones(256, dtype=torch.float64), mesh=cpu_mesh())
    with pytest.raises(ValueError, match="rows"):
        T.dist_solve_ir_multi(A, torch.ones(255, 2, dtype=torch.float64), mesh=cpu_mesh())
    # the distributed AMG is ported: pc="saamg" solves where it raised before
    _, info = T.dist_solve_multi(A, torch.ones(256, 2, dtype=torch.float64), pc="saamg",
                                 mesh=cpu_mesh())
    assert info.converged.all()
    # n = 225 is not a multiple of 8: identity rows pad the block too
    A15 = T.sparse.laplacian_2d(15)
    B = np.stack([np.ones(225), np.arange(225.0)], axis=1)
    X, info = T.dist_solve_multi(A15, torch.from_numpy(B), method="cg", pc="jacobi",
                                 mesh=cpu_mesh())
    assert X.shape == (225, 2) and info.converged.all()
