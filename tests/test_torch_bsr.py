"""Block matrices of lssp_tpu_torch against lssp_tpu on the CPU: the BSR and
BDIA containers, their conversions, products and the facade's BSR route.

Tolerances: the conversions bitwise (the same arrays, the same
``ValueError``s); the BSR / BDIA products, single and k-rhs, to 1e-13
relative to max|y| in fp64 (JAX sums a block row in another order);
solves through a BSR: counts JAX's ±1 and x to 1e-8 relative, the true
relative residual ≤ 1e-8 for ``solve_ir``.  The facade prepares scalar DIA
when len(offsets)·n ≤ 3·nnz, else BDIA, else ELL, with one memo entry a
matrix, invalidated when its blocks change.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops.spmv import spmv as jspmv
from lssp_tpu.sparse.convert import bsr_to_bdia as jbsr_to_bdia
import lssp_tpu_torch as T
from lssp_tpu_torch.ops.spmv import spmv
from lssp_tpu_torch.solvers.facade import _prepare_matrix

GENS = [("laplacian_2d", 12, 4), ("elasticity_2d", 10, 2), ("laplacian_3d", 6, 3),
        ("convection_diffusion_2d", 8, 8)]
IDS = [f"{g}({N})-bs{bs}" for g, N, bs in GENS]


def _pair(gen, N, bs):
    Aj, At = getattr(J.sparse, gen)(N), getattr(T.sparse, gen)(N)
    return J.sparse.csr_to_bsr(Aj, bs), T.sparse.csr_to_bsr(At, bs)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("gen,N,bs", GENS, ids=IDS)
def test_conversions_bitwise(gen, N, bs):
    Bj, Bt = _pair(gen, N, bs)
    for f in ("indptr", "indices", "blocks"):
        assert _same(getattr(Bt, f), getattr(Bj, f)), f
    assert Bt.shape == Bj.shape and Bt.blocksize == Bj.blocksize == bs
    Cj, Ct = J.sparse.bsr_to_csr(Bj), T.sparse.bsr_to_csr(Bt)
    for f in ("indptr", "indices", "data"):
        assert _same(getattr(Ct, f), getattr(Cj, f)), f
    Cj, Ct = J.sparse.bsr_to_csr(Bj, prune=False), T.sparse.bsr_to_csr(Bt, prune=False)
    assert _same(Ct.data, Cj.data) and _same(Ct.indices, Cj.indices)
    for md, fill in ((32, 2.0), (48, 3.0)):
        Dj = jbsr_to_bdia(Bj, max_diags=md, fill=fill)
        Dt = T.sparse.bsr_to_bdia(Bt, max_diags=md, fill=fill)
        assert Dt.offsets == tuple(Dj.offsets) and _same(Dt.blocks.numpy(), Dj.blocks)
        np.testing.assert_array_equal(Dt.todense(), Bt.todense())


def test_conversion_errors_match_jax():
    A = T.sparse.laplacian_2d(5)                       # n = 25
    Aj = J.sparse.laplacian_2d(5)
    with pytest.raises(ValueError) as et:
        T.sparse.csr_to_bsr(A, 4)
    with pytest.raises(ValueError) as ej:
        J.sparse.csr_to_bsr(Aj, 4)
    assert str(et.value) == str(ej.value)
    R = sp.random(64, 64, density=0.3, random_state=1, format="csr") + sp.eye(64)
    Bt = T.sparse.csr_to_bsr(T.sparse.CSR.from_scipy(R.tocsr()), 2)
    Bj = J.sparse.csr_to_bsr(J.sparse.CSR.from_scipy(R.tocsr()), 2)
    for kw in (dict(max_diags=4), dict(max_diags=64, fill=0.5)):
        with pytest.raises(ValueError) as et:
            T.sparse.bsr_to_bdia(Bt, **kw)
        with pytest.raises(ValueError) as ej:
            jbsr_to_bdia(Bj, **kw)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("gen,N,bs", GENS, ids=IDS)
def test_products_match_jax(gen, N, bs, k):
    Bj, Bt = _pair(gen, N, bs)
    n = Bj.shape[0]
    X = np.random.default_rng(n).standard_normal((n, k) if k else n)
    Dj = jbsr_to_bdia(Bj, max_diags=48, fill=3.0)
    Dt = T.sparse.bsr_to_bdia(Bt, max_diags=48, fill=3.0)
    cols = [X] if not k else [X[:, c] for c in range(k)]
    for Mj, Mt in ((Bj, Bt.to("cpu")), (Dj, Dt)):
        ref = np.stack([np.asarray(jspmv(Mj, jnp.asarray(x))) for x in cols], axis=-1)
        got = spmv(Mt, torch.from_numpy(X)).numpy()
        assert _rel(got, ref if k else ref[:, 0]) <= 1e-13


def test_device_bsr_needs_upload():
    Bt = T.sparse.csr_to_bsr(T.sparse.laplacian_2d(4), 2)
    with pytest.raises(TypeError):
        spmv(Bt, torch.ones(16, dtype=torch.float64))


def _banded_bsr(nb=64, bs=8, seed=0):
    """Dense 8×8 blocks on the block diagonals −20, −10, 0, 10, 20: scalar
    DIA would need 75 diagonals (> 64), BDIA takes 5."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(nb):
        for j in (i - 20, i - 10, i, i + 10, i + 20):
            if 0 <= j < nb:
                rows.append(i)
                cols.append(j)
    ip = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nb))]).astype(np.int32)
    blocks = rng.standard_normal((len(cols), bs, bs))
    for q, (i, j) in enumerate(zip(rows, cols)):
        if i == j:
            blocks[q] += 4 * bs * np.eye(bs)
    return ip, np.asarray(cols, np.int32), blocks, (nb * bs, nb * bs), bs


def test_facade_format_rule_matches_jax():
    from lssp_tpu.solvers.facade import _prepare_matrix as jprep
    # elasticity 2x2 blocks: scalar DIA (K1)
    Bj, Bt = _pair("elasticity_2d", 12, 2)
    _, dj, _ = jprep(Bj)
    ht, dt, _, _ = _prepare_matrix(Bt, device="cpu")
    assert type(dj).__name__ == type(dt).__name__ == "DIA"
    assert dt.offsets == tuple(dj.offsets)
    np.testing.assert_array_equal(dt.data.numpy(), np.asarray(dj.data))
    assert isinstance(ht, T.sparse.CSR)
    # dense 8x8 blocks on five spread block diagonals: BDIA
    parts = _banded_bsr()
    _, dj, _ = jprep(J.sparse.BSR(*parts))
    _, dt, _, _ = _prepare_matrix(T.sparse.BSR(*parts), device="cpu")
    assert type(dj).__name__ == type(dt).__name__ == "BDIA"
    np.testing.assert_array_equal(dt.blocks.numpy(), np.asarray(dj.blocks))
    # random blocks, many block diagonals: ELL
    R = sp.random(128, 128, density=0.05, random_state=3, format="csr") + 4 * sp.eye(128)
    Bj = J.sparse.csr_to_bsr(J.sparse.CSR.from_scipy(R.tocsr()), 2)
    Bt = T.sparse.csr_to_bsr(T.sparse.CSR.from_scipy(R.tocsr()), 2)
    _, dj, _ = jprep(Bj)
    _, dt, _, _ = _prepare_matrix(Bt, device="cpu")
    assert type(dj).__name__ == type(dt).__name__ == "ELL"


def test_bsr_memo_one_entry_and_invalidation():
    Bt = T.sparse.csr_to_bsr(T.sparse.elasticity_2d(8), 2)
    b = torch.ones(Bt.shape[0], dtype=torch.float64)
    o = T.SolverOptions(maxit=500)
    T.solve(Bt, b, method="gmres", device="cpu", options=o)
    T.solve(Bt, b, method="gmres", reorder=None, device="cpu", options=o)
    T.solve(Bt, b, method="gmres", pc="saamg", device="cpu", options=o)
    prepared = [k for k in Bt._prepared_cache if k[0] == "prepared"]
    assert prepared == [("prepared", "bsr", "cpu")]
    dev = Bt._prepared_cache[prepared[0]][1]
    Bt.blocks[0, 0, 0] += 1.0                        # in-place change of a value
    _, dev2, _, _ = _prepare_matrix(Bt, device="cpu")
    assert dev2 is not dev
    assert float(dev2.data[list(dev2.offsets).index(0)][0]) == float(Bt.blocks[0, 0, 0])


@pytest.mark.parametrize("method,pc", [("gmres", "none"), ("cg", "jacobi"), ("bicgstab", "iluk")])
def test_solve_on_bsr_matches_jax(method, pc):
    Bj, Bt = _pair("elasticity_2d", 12, 2)
    n = Bj.shape[0]
    o = dict(maxit=2000, restart=60)
    xj, ij = J.solve(Bj, jnp.ones(n), method=method, pc=pc, options=J.SolverOptions(**o),
                     pc_options=J.PCOptions(ilu_sweeps=0))
    xt, it = T.solve(Bt, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                     options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=0))
    assert it.converged and bool(ij.converged) and abs(it.nits - int(ij.nits)) <= 1
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_solve_ir_multi_and_solver_on_bsr():
    Bj, Bt = _pair("elasticity_2d", 16, 2)
    n = Bj.shape[0]
    S = Bt.to_scipy()
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    po = dict(block_size=2, ilu_sweeps=0)
    xt, it = T.solve_ir(Bt, torch.ones(n, dtype=torch.float64), method="bicgstabl",
                        pc="biluk", options=T.SolverOptions(**o), pc_options=T.PCOptions(**po),
                        device="cpu")
    xj, ij = J.solve_ir(Bj, jnp.ones(n), method="bicgstabl", pc="biluk",
                        options=J.SolverOptions(**o), pc_options=J.PCOptions(**po))
    assert it.converged and abs(it.nits - int(ij.nits)) <= max(2, int(0.15 * int(ij.nits)))
    assert np.linalg.norm(1.0 - S @ xt.numpy()) <= 1e-8 * np.sqrt(n)
    B = np.random.default_rng(2).standard_normal((n, 4))
    X, info = T.solve_ir_multi(Bt, torch.from_numpy(B), method="blockcg", pc="biluk",
                               options=T.SolverOptions(**o), pc_options=T.PCOptions(**po),
                               device="cpu")
    assert info.converged.all()
    assert np.all(np.linalg.norm(B - S @ X.numpy(), axis=0)
                  <= 1e-8 * np.linalg.norm(B, axis=0))
    X, info = T.solve_multi(Bt, torch.from_numpy(B), method="cg", pc="biluk",
                            options=T.SolverOptions(maxit=2000), pc_options=T.PCOptions(**po))
    Xj, ij = J.solve_multi(Bj, jnp.asarray(B), method="cg", pc="biluk",
                           options=J.SolverOptions(maxit=2000), pc_options=J.PCOptions(**po))
    assert np.all(np.abs(info.nits - np.asarray(ij.nits)) <= 1)
    s = T.Solver(method="cg", pc="biluk", pc_options=T.PCOptions(**po), device="cpu",
                 options=T.SolverOptions(**o))
    x = s.assemble(Bt, torch.ones(n, dtype=torch.float64)).solve()
    assert s.info.converged and np.linalg.norm(1.0 - S @ x.numpy()) <= 1e-7 * np.sqrt(n)
