"""The distributed transpose path of lssp_tpu_torch against lssp_tpu on the
CPU: ``make_dist_spmv_t`` (DistDIA, DistHYB, DistELL in halo and all-gather
mode) against JAX's ``shard_map`` product on its 8-device mesh
(``tests/conftest.py``), the shard-local M⁻ᵀ of block-Jacobi ILU against
JAX's shard by shard, and ``dist_solve`` / ``dist_solve_ir`` with bicg,
qmr, cgnr and lsqr.

Products and applies in fp64 to 1e-13 / 1e-12 (sums in another order);
solves: counts within ±2 and x to 1e-8 relative, as
``tests/test_torch_dist.py`` holds the forward methods.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import lssp_tpu as J
from lssp_tpu.parallel import dist_ops as jops
from lssp_tpu.parallel import dist_solve as jsolve
from lssp_tpu.parallel import partition as jpart
import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import partition as tpart
from lssp_tpu_torch.parallel.dist_ops import OpWithTranspose, make_dist_spmv, make_dist_spmv_t
from test_torch_dist import both, cpu_mesh
from test_torch_transpose import port_inner_cap  # noqa: F401 (a fixture)

# the module (``lssp_tpu_torch.parallel`` re-exports a function of its name)
tsolve = importlib.import_module("lssp_tpu_torch.parallel.dist_solve")


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


def _jax_dist_spmv_t(Mj, mesh, x):
    op = jops.make_dist_spmv_t(Mj, "shards")
    leaves, _ = jax.tree_util.tree_flatten(Mj)
    f = jax.shard_map(lambda *a: op(*[q[0] for q in a[:-1]], a[-1][0])[None], mesh=mesh,
                      in_specs=tuple(P("shards") for _ in range(len(leaves) + 1)),
                      out_specs=P("shards"), check_vma=False)
    return np.asarray(f(*[jnp.asarray(l) for l in leaves],
                        jnp.asarray(x.reshape(8, -1)))).reshape(-1)


PRODUCTS = [("convdiff_32", "dia", "DistDIA"), ("nearly_banded", "hyb", "DistHYB"),
            ("convdiff_32", "halo", "DistELL"), ("random_sparse_64", "allgather", "DistELL")]


@pytest.mark.parametrize("name,fmt,kind", PRODUCTS)
def test_dist_spmv_t_matches_jax(name, fmt, kind, mesh8):
    """Aᵀx against JAX's ``make_dist_spmv_t`` on ``mesh8`` and scipy; an
    (n, k) block column by column; ``OpWithTranspose`` carries it."""
    Aj, At = both(name)
    Mj = jpart.partition_matrix(Aj, 8, fmt=fmt)
    Mt = tpart.partition_matrix(At, 8, fmt=fmt)
    assert type(Mt).__name__ == kind
    rng = np.random.default_rng(5)
    x, X = rng.standard_normal(At.shape[0]), rng.standard_normal((At.shape[0], 3))
    op_t = make_dist_spmv_t(Mt)
    y = op_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, _jax_dist_spmv_t(Mj, mesh8, x), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y, At.to_scipy().T @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op_t(torch.from_numpy(X)).numpy(), At.to_scipy().T @ X,
                               rtol=1e-13, atol=1e-13)
    op = OpWithTranspose(make_dist_spmv(Mt), op_t)
    assert op.shards == 8 and op.t_op is op_t
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(), At.to_scipy() @ x, rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("name,pc,sweeps,kind", [("laplacian_2d_16", "bjilu", 6, "ilu_nm"),
                                                 ("convdiff_32", "ilut", -1, "ilu_nm"),
                                                 ("union_buster", "bjilu", 3, "ilu_nmd"),
                                                 ("convdiff_32", "iluk", 0, "ilu"),
                                                 ("convdiff_32", "jacobi", None, "jacobi")])
def test_shard_pc_transpose_matches_jax(name, pc, sweeps, kind):
    """The shard-local M⁻ᵀ (the transposed bands on K4's path, the dynamic
    offsets' transposed stream, the exact transposed schedules, Jacobi)
    against JAX's ``.t`` shard by shard, fp64, 1e-12; the transposed bands
    hold the forward bands' values."""
    Aj, At = both(name)
    R = At.shape[0] // 8
    kj, sj = jsolve._build_dist_pc(Aj, pc, J.PCOptions(ilu_sweeps=sweeps).resolved(), 8, R,
                                   transpose=True)
    kt, st = tsolve._build_dist_pc(At, pc, T.PCOptions(ilu_sweeps=sweeps,
                                                       transpose=True).resolved(), 8, R,
                                   torch.device("cpu"))
    assert kt == kj == kind
    if kind == "ilu_nm":
        for F, Ft in ((st.L, st.Lt), (st.U, st.Ut)):
            assert Ft.offsets == tuple(sorted(-o for o in F.offsets))
            assert torch.equal(torch.sort(F.data.flatten()).values,
                               torch.sort(Ft.data.flatten()).values)
    r = np.random.default_rng(6).standard_normal(At.shape[0])
    fn = tsolve._shard_pc_apply(kt, st, 8, R)
    z = fn.t(torch.from_numpy(r)).numpy().reshape(8, R)
    for p in (0, 3, 7):
        loc = jax.tree_util.tree_map(lambda a: a[p], sj)
        ref = np.asarray(jsolve._shard_pc_apply(kj, loc, R).t(jnp.asarray(r.reshape(8, R)[p])))
        np.testing.assert_allclose(z[p], ref, rtol=1e-12, atol=1e-12)
    R2 = np.random.default_rng(7).standard_normal((At.shape[0], 2))
    Z = fn.t(torch.from_numpy(R2)).numpy()
    np.testing.assert_allclose(Z[:, 1], fn.t(torch.from_numpy(R2[:, 1].copy())).numpy(),
                               rtol=1e-14, atol=1e-14)


SOLVES = {"bicg_bjilu6": ("convdiff_32", "bicg", "bjilu", "auto", 6),
          "bicg_bjilu_exact": ("convdiff_32", "bicg", "bjilu", "auto", 0),
          "qmr_jacobi": ("convdiff_32", "qmr", "jacobi", "auto", None),
          "qmr_bjilu_hyb": ("nearly_banded", "qmr", "bjilu", "hyb", 6),
          "cgnr_none": ("laplacian_2d_16", "cgnr", "none", "auto", None),
          "lsqr_bjilu_ell": ("laplacian_2d_16", "lsqr", "bjilu", "ell", 6)}


@pytest.mark.parametrize("case", list(SOLVES))
def test_dist_solve_transpose_matches_jax(case, mesh8):
    name, method, pc, fmt, sweeps = SOLVES[case]
    Aj, At = both(name)
    n = At.shape[0]
    kw = dict(method=method, pc=pc, fmt=fmt)
    xj, ij = jsolve.dist_solve(Aj, jnp.ones(n), mesh=mesh8, options=J.SolverOptions(maxit=3000),
                               pc_options=J.PCOptions(ilu_sweeps=sweeps), **kw)
    xt, it = T.dist_solve(At, torch.ones(n, dtype=torch.float64), mesh=cpu_mesh(),
                          options=T.SolverOptions(maxit=3000),
                          pc_options=T.PCOptions(ilu_sweeps=sweeps), **kw)
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 2, (it.nits, int(ij.nits))
    if it.nits == int(ij.nits):
        xj = np.asarray(xj)
        assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


@pytest.mark.parametrize("method,pc", [("bicg", "bjilu"), ("qmr", "jacobi"), ("lsqr", "bjilu")])
def test_dist_solve_ir_transpose_matches_jax(method, pc, mesh8, port_inner_cap):
    """dist_solve_ir (fp32 inner, 6 sweeps, rtol 1e-8) on the 2-D Laplacian
    32²: counts within ±max(2, 5 %) of JAX's under the port's inner policy,
    true residual."""
    Aj, At = J.sparse.laplacian_2d(32), T.sparse.laplacian_2d(32)
    n = At.shape[0]
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0)
    _, ij = jsolve.dist_solve_ir(Aj, jnp.ones(n), method=method, pc=pc, mesh=mesh8,
                                 options=J.SolverOptions(**o),
                                 pc_options=J.PCOptions(ilu_sweeps=6))
    x, it = T.dist_solve_ir(At, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                            mesh=cpu_mesh(), options=T.SolverOptions(**o),
                            pc_options=T.PCOptions(ilu_sweeps=6))
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= max(2, int(0.05 * int(ij.nits)))
    assert np.linalg.norm(1.0 - At.to_scipy() @ x.numpy()) <= 1e-8 * np.sqrt(n) * 1.01


def test_dist_transpose_pc_gate():
    """A transpose method takes only the PCs with a distributed M⁻ᵀ, as in
    JAX (``dist_solve.py:755-761``); its block form runs per column."""
    At = T.sparse.laplacian_2d(16)
    b = torch.ones(256, dtype=torch.float64)
    for pc in ("saamg", "amg"):
        with pytest.raises(ValueError, match="no distributed transpose apply"):
            T.dist_solve(At, b, method="bicg", pc=pc, mesh=cpu_mesh())
    X, info = T.dist_solve_multi(At, torch.ones(256, 2, dtype=torch.float64), method="qmr",
                                 pc="bjilu", mesh=cpu_mesh(),
                                 pc_options=T.PCOptions(ilu_sweeps=6))
    _, single = T.dist_solve(At, b, method="qmr", pc="bjilu", mesh=cpu_mesh(),
                             pc_options=T.PCOptions(ilu_sweeps=6))
    assert info.converged.all() and np.all(np.abs(info.nits - single.nits) <= 1)
