"""The distributed slice of lssp_tpu_torch (``parallel/``: partitioning, the
halo-exchange products, K4's plain version ``dia_spmv_ext_plain``, the
block-Jacobi preconditioners, ``dist_solve`` / ``dist_solve_ir``) against
lssp_tpu on the CPU.

JAX runs on its 8-virtual-device mesh (``tests/conftest.py``); the port
runs the same 8 shards as the leading axis of tensors on one CPU device.
The partition is the same numpy code, so its arrays must be identical.
Products: fp64 to rtol 1e-13 against JAX's ``shard_map`` products (sums in
another order); K4's plain version against the Pallas prepadded kernel run
with ``interpret=True``, per shard, to 2e-5 (fp32) / 1e-12 (fp64).
Solves: iteration counts within ±2 (the port's solvers sum ``torch.dot``
over n, JAX's per-shard partials, as ``tests/test_dist.py`` allows against
the single-device solve) and x within 1e-8 relative.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

import lssp_tpu as J
from lssp_tpu.ops.pallas_spmv import dia_spmv_pallas_ext
from lssp_tpu.parallel import dist_ops as jops
from lssp_tpu.parallel import dist_solve as jsolve
from lssp_tpu.parallel import partition as jpart
import lssp_tpu_torch as T
from lssp_tpu_torch import interop
from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmv_ext, dia_spmv_ext_plain
from lssp_tpu_torch.parallel import partition as tpart
from lssp_tpu_torch.parallel.dist_ops import (apply_dist_spmv, halo_exchange,
                                              make_dist_spmv, make_psum_dot)

# the module (``lssp_tpu_torch.parallel`` re-exports a function of its name)
tsolve = importlib.import_module("lssp_tpu_torch.parallel.dist_solve")


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


def cpu_mesh(p=8):
    return T.make_mesh(p, devices=[torch.device("cpu")] * p)


def nearly_banded(n_side=16, n_extra=40, seed=4):
    """TestDistHYB._nearly_banded (tests/test_dist.py)."""
    rng = np.random.default_rng(seed)
    S = J.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] += 0.02
    return S.tocsr()


def union_buster(n=1024, Pn=8):
    """tests/test_dist.py:_union_buster: block-diagonal, each shard block
    narrow-banded at different offsets, so the union of the shards'
    offsets exceeds the streaming cap (96) while no shard does."""
    R = n // Pn
    blocks = []
    rng = np.random.default_rng(3)
    for p in range(Pn):
        offs = [0] + [-(1 + 14 * p + j) for j in range(14)] + [1 + 14 * p + j for j in range(14)]
        diags, keep = [], []
        for o in offs:
            if abs(o) >= R:
                continue
            diags.append(40.0 * np.ones(R) if o == 0 else -rng.uniform(0.1, 0.5, R - abs(o)))
            keep.append(o)
        blocks.append(sp.diags(diags, keep, shape=(R, R)))
    return sp.block_diag(blocks, format="csr")


def reach40(n=256):
    return sp.diags([np.ones(n - 40), 2 * np.ones(n), np.ones(n - 40)], [-40, 0, 40],
                    format="csr")


MATRICES = {
    "laplacian_2d_16": lambda: J.sparse.laplacian_2d(16).to_scipy(),
    "convdiff_32": lambda: J.sparse.convection_diffusion_2d(32, beta=10.0).to_scipy(),
    "nearly_banded": nearly_banded,
    "random_sparse_64": lambda: J.sparse.random_sparse(64, 6).to_scipy(),
    "laplacian_2d_15": lambda: J.sparse.laplacian_2d(15).to_scipy(),
    "union_buster": union_buster,
    "reach40": reach40,
}


def both(name):
    S = sp.csr_matrix(MATRICES[name]())
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


def _rem_triplets(rows, cols, vals, p):
    t = np.stack([np.asarray(rows)[p], np.asarray(cols)[p], np.asarray(vals)[p]], axis=1)
    return t[np.lexsort(t.T[::-1])]


def assert_same_partition(Mj, Mt):
    assert type(Mt).__name__ == type(Mj).__name__
    if isinstance(Mt, tpart.DistHYB):
        assert_same_partition(Mj.band, Mt.band)
        for p in range(Mt.nshards):
            np.testing.assert_array_equal(
                _rem_triplets(Mt.rem_rows, Mt.rem_cols, Mt.rem_vals, p),
                _rem_triplets(Mj.rem_rows, Mj.rem_cols, Mj.rem_vals, p))
        return
    assert (Mt.n, Mt.nshards) == (Mj.n, Mj.nshards)
    if isinstance(Mt, tpart.DistDIA):
        assert Mt.offsets == Mj.offsets and (Mt.lo, Mt.hi) == (Mj.lo, Mj.hi)
        np.testing.assert_array_equal(Mt.data.numpy(), np.asarray(Mj.data))
    else:
        assert (Mt.mode, Mt.halo) == (Mj.mode, Mj.halo)
        np.testing.assert_array_equal(Mt.cols.numpy(), np.asarray(Mj.cols))
        np.testing.assert_array_equal(Mt.data.numpy(), np.asarray(Mj.data))


@pytest.mark.parametrize("nshards", [8, 4])
@pytest.mark.parametrize("name,kind", [("laplacian_2d_16", "DistDIA"),
                                       ("convdiff_32", "DistDIA"),
                                       ("nearly_banded", "DistHYB"),
                                       ("random_sparse_64", "DistELL")])
def test_partition_matrix_matches_jax(name, kind, nshards):
    Aj, At = both(name)
    Mt = tpart.partition_matrix(At, nshards)
    assert type(Mt).__name__ == kind
    assert_same_partition(jpart.partition_matrix(Aj, nshards), Mt)


@pytest.mark.parametrize("fmt", ["dia", "hyb", "ell", "halo", "allgather"])
def test_partition_forced_formats_match_jax(fmt):
    Aj, At = both("nearly_banded" if fmt == "hyb" else "laplacian_2d_16")
    assert_same_partition(jpart.partition_matrix(Aj, 8, fmt=fmt),
                          tpart.partition_matrix(At, 8, fmt=fmt))


def test_partition_errors():
    Aj, At = both("reach40")                         # R = 32 < 40
    with pytest.raises(ValueError, match="reach"):
        tpart.partition_csr_dia(At, 8)
    with pytest.raises(ValueError, match="reach"):
        tpart.partition_matrix(At, 8, fmt="dia")
    assert_same_partition(jpart.partition_matrix(Aj, 8), tpart.partition_matrix(At, 8))
    with pytest.raises(ValueError, match="not divisible"):
        tpart.partition_csr_dia(both("laplacian_2d_15")[1], 8)
    with pytest.raises(ValueError, match="halo mode"):
        tpart.partition_csr(both("random_sparse_64")[1], 8, mode="halo")
    with pytest.raises(ValueError, match="unknown distributed format"):
        tpart.partition_matrix(At, 8, fmt="csr")


def test_halo_exchange_is_the_ring():
    x = torch.arange(24.0).view(4, 6)
    e = halo_exchange(x, 2, 1)
    assert e.shape == (4, 9)
    np.testing.assert_array_equal(e[1].numpy(), [4, 5, 6, 7, 8, 9, 10, 11, 12])
    np.testing.assert_array_equal(e[0, :2].numpy(), [22, 23])    # wraps from shard 3
    assert e[3, -1].item() == 0.0                                 # wraps from shard 0
    assert halo_exchange(x, 0, 0) is x
    assert torch.equal(tpart.shard_vector(np.arange(24.0), 4), x.double())
    assert torch.equal(tpart.unshard_vector(x), torch.arange(24.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_spmv_ext_plain_matches_pallas(dtype):
    """Per shard, against the Pallas prepadded kernel in interpret mode,
    on random halos; and the sweep epilogue (α, β, z) = (−1, 1, r)."""
    _, At = both("convdiff_32")
    M = tpart.partition_csr_dia(At.astype(dtype), 4)             # R = 256, lo = hi = 32
    R, lo, hi = M.rows_per_shard, M.lo, M.hi
    rng = np.random.default_rng(7)
    x_ext = rng.standard_normal((4, R + lo + hi)).astype(dtype)
    z = rng.standard_normal((4, R)).astype(dtype)
    y = dia_spmv_ext_plain(M.data, M.offsets, torch.from_numpy(x_ext))
    ys = dia_spmv_ext(M.data, M.offsets, torch.from_numpy(x_ext), -1.0, 1.0,
                      torch.from_numpy(z))
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for p in range(4):
        ref = np.asarray(dia_spmv_pallas_ext(jnp.asarray(M.data[p].numpy()),
                                             jnp.asarray(x_ext[p]), M.offsets,
                                             interpret=True))
        assert y.dtype == torch.from_numpy(z).dtype
        np.testing.assert_allclose(y[p].numpy(), ref, rtol=tol, atol=tol)
        np.testing.assert_allclose(ys[p].numpy(), z[p] - ref, rtol=tol, atol=tol)


def _jax_dist_spmv(Mj, mesh, x):
    op = jops.make_dist_spmv(Mj, "shards")
    leaves, _ = jax.tree_util.tree_flatten(Mj)
    f = jax.shard_map(lambda *a: op(*[q[0] for q in a[:-1]], a[-1][0])[None], mesh=mesh,
                      in_specs=tuple(P("shards") for _ in range(len(leaves) + 1)),
                      out_specs=P("shards"), check_vma=False)
    return np.asarray(f(*[jnp.asarray(l) for l in leaves],
                        jnp.asarray(x.reshape(8, -1)))).reshape(-1)


PRODUCTS = [("laplacian_2d_16", "dia"), ("convdiff_32", "dia"), ("nearly_banded", "hyb"),
            ("laplacian_2d_16", "halo"), ("random_sparse_64", "allgather")]


@pytest.mark.parametrize("name,fmt", PRODUCTS)
def test_dist_spmv_matches_jax(name, fmt, mesh8):
    Aj, At = both(name)
    Mj = jpart.partition_matrix(Aj, 8, fmt=fmt)
    Mt = tpart.partition_matrix(At, 8, fmt=fmt)
    x = np.random.default_rng(1).standard_normal(At.shape[0])
    y = make_dist_spmv(Mt)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, _jax_dist_spmv(Mj, mesh8, x), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y, At.to_scipy() @ x, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name,fmt", PRODUCTS)
def test_interop_partitions_give_the_port_product(name, fmt):
    """JAX's partition arrays, carried over by ``dist_*_from_arrays``, give
    the port's own product."""
    Aj, At = both(name)
    Mj = jpart.partition_matrix(Aj, 8, fmt=fmt)
    if isinstance(Mj, jpart.DistHYB):
        b = Mj.band
        Mc = interop.dist_hyb_from_arrays(np.asarray(b.data), b.offsets, b.n, b.nshards,
                                          *(np.asarray(a) for a in (Mj.rem_rows, Mj.rem_cols,
                                                                    Mj.rem_vals)))
    elif isinstance(Mj, jpart.DistDIA):
        Mc = interop.dist_dia_from_arrays(np.asarray(Mj.data), Mj.offsets, Mj.n, Mj.nshards)
    else:
        Mc = interop.dist_ell_from_arrays(np.asarray(Mj.cols), np.asarray(Mj.data), Mj.n,
                                          Mj.nshards, Mj.halo, Mj.mode)
    assert_same_partition(Mj, Mc)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(At.shape[0]))
    np.testing.assert_allclose(apply_dist_spmv(Mc, x).numpy(),
                               apply_dist_spmv(tpart.partition_matrix(At, 8, fmt=fmt), x).numpy(),
                               rtol=1e-14, atol=1e-14)


def test_psum_dot():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(64))
    assert abs(make_psum_dot(8)(x, x).item() - torch.dot(x, x).item()) <= 1e-12 * 64


@pytest.mark.parametrize("name,pc,sweeps,kind", [("laplacian_2d_16", "bjilu", 6, "ilu_nm"),
                                                 ("convdiff_32", "ilut", -1, "ilu_nm"),
                                                 ("union_buster", "bjilu", 3, "ilu_nmd"),
                                                 ("laplacian_2d_16", "jacobi", None, "jacobi")])
def test_dist_pc_matches_jax(name, pc, sweeps, kind):
    """The per-shard preconditioner state and its apply, shard by shard."""
    Aj, At = both(name)
    R = At.shape[0] // 8
    kj, sj = jsolve._build_dist_pc(Aj, pc, J.PCOptions(ilu_sweeps=sweeps).resolved(), 8, R)
    kt, st = tsolve._build_dist_pc(At, pc, T.PCOptions(ilu_sweeps=sweeps).resolved(), 8, R,
                                   torch.device("cpu"))
    assert kt == kj == kind
    if kind == "ilu_nm":
        assert (st.L.offsets, st.U.offsets, st.sweeps) == (sj.offL, sj.offU, sj.sweeps)
        np.testing.assert_array_equal(st.L.data.numpy(), np.asarray(sj.Ldata))
        np.testing.assert_array_equal(st.U.data.numpy(), np.asarray(sj.Udata))
    if kind == "ilu_nmd":
        np.testing.assert_array_equal(st.Loff.numpy(), np.asarray(sj.Loff))
        np.testing.assert_array_equal(st.Udata.numpy(), np.asarray(sj.Udata))
    r = np.random.default_rng(4).standard_normal(At.shape[0])
    z = tsolve._shard_pc_apply(kt, st, 8, R)(torch.from_numpy(r)).numpy().reshape(8, R)
    for p in (0, 3, 7):
        loc = jax.tree_util.tree_map(lambda a: a[p], sj)
        ref = np.asarray(jsolve._shard_pc_apply(kj, loc, R)(jnp.asarray(r.reshape(8, R)[p])))
        np.testing.assert_allclose(z[p], ref, rtol=1e-12, atol=1e-12)


SOLVES = {
    "cg_none_dia": ("laplacian_2d_16", "cg", "none", "dia", None),
    "gmres_jacobi_dia": ("laplacian_2d_16", "gmres", "jacobi", "dia", None),
    "bicgstab_bjilu_dia": ("laplacian_2d_16", "bicgstab", "bjilu", "dia", None),
    "cg_bjilu_sweeps0": ("laplacian_2d_16", "cg", "bjilu", "auto", 0),
    "cg_bjilu_sweeps6": ("laplacian_2d_16", "cg", "bjilu", "auto", 6),
    "cg_bjilu_exact_series": ("laplacian_2d_16", "cg", "bjilu", "auto", -1),
    "gmres_jacobi_hyb": ("nearly_banded", "gmres", "jacobi", "hyb", None),
    "bicgstab_bjilu_hyb": ("nearly_banded", "bicgstab", "bjilu", "hyb", 6),
    "cg_jacobi_ell_halo": ("laplacian_2d_16", "cg", "jacobi", "ell", None),
    "gmres_none_ell_allgather": ("random_sparse_64", "gmres", "none", "ell", None),
    "cg_bjilu_prime_n": ("laplacian_2d_15", "cg", "bjilu", "auto", None),
    "gmres_jacobi_prime_n": ("laplacian_2d_15", "gmres", "jacobi", "auto", None),
    "bicgstab_ilu_nmd": ("union_buster", "bicgstab", "bjilu", "auto", 3),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_dist_solve_matches_jax(case, mesh8):
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
    assert xt.shape == (n,) and xt.dtype == torch.float64
    assert abs(it.nits - int(ij.nits)) <= 2
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_dist_solve_ir_cg_ilu0_32(mesh8):
    """The main path at 32³: cg + ILU(0), 6 sweeps, relres 1e-8 (JAX: 61)."""
    Aj, At = J.sparse.laplacian_3d(32), T.sparse.laplacian_3d(32)
    n = At.shape[0]
    jkw = dict(method="cg", pc="ilu0", options=J.SolverOptions(rtol=1e-8, atol=0),
               pc_options=J.PCOptions(ilu_sweeps=6))
    xj, ij = jsolve.dist_solve_ir(Aj, jnp.ones(n), mesh=mesh8, **jkw)
    xt, it = T.dist_solve_ir(At, torch.ones(n, dtype=torch.float64), mesh=cpu_mesh(),
                             method="cg", pc="ilu0",
                             options=T.SolverOptions(rtol=1e-8, atol=0),
                             pc_options=T.PCOptions(ilu_sweeps=6))
    assert int(ij.nits) == 61
    assert abs(it.nits - 61) <= 2 and it.converged
    relres = np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) / np.sqrt(n)
    assert relres <= 1e-8
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-6 * np.linalg.norm(np.asarray(xj))


@pytest.mark.parametrize("method,pc,fmt", [("gmres", "bjilu", "auto"),
                                           ("bicgstab", "jacobi", "hyb")])
def test_dist_solve_ir_matches_jax(method, pc, fmt, mesh8):
    name = "convdiff_32" if fmt == "auto" else "nearly_banded"
    Aj, At = both(name)
    n = At.shape[0]
    xj, ij = jsolve.dist_solve_ir(Aj, jnp.ones(n), method=method, pc=pc, fmt=fmt, mesh=mesh8,
                                  options=J.SolverOptions(rtol=1e-10, atol=0),
                                  pc_options=J.PCOptions(ilu_sweeps=6))
    xt, it = T.dist_solve_ir(At, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                             fmt=fmt, mesh=cpu_mesh(),
                             options=T.SolverOptions(rtol=1e-10, atol=0),
                             pc_options=T.PCOptions(ilu_sweeps=6))
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 2
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_dist_solve_bad_input():
    _, At = both("laplacian_2d_16")
    mesh = cpu_mesh()
    with pytest.raises(ValueError, match="rhs length"):
        T.dist_solve(At, torch.ones(255, dtype=torch.float64), mesh=mesh)
    with pytest.raises(ValueError, match="unknown solver"):
        T.dist_solve(At, torch.ones(256, dtype=torch.float64), method="nope", mesh=mesh)
    with pytest.raises(ValueError, match="unknown solver"):
        T.dist_solve_ir(At, torch.ones(256, dtype=torch.float64), method="nope", mesh=mesh)
    with pytest.raises(ValueError, match="x0 must match"):
        T.dist_solve(At, torch.ones(256, dtype=torch.float64), x0=torch.zeros(3), mesh=mesh)
    with pytest.raises(ValueError, match="unsupported distributed pc"):
        T.dist_solve(At, torch.ones(256, dtype=torch.float64), pc="ilutp", mesh=mesh)
    # the distributed AMG is ported: pc="saamg" solves where it raised before
    _, info = T.dist_solve(At, torch.ones(256, dtype=torch.float64), pc="saamg", mesh=mesh)
    assert info.converged


def test_mesh():
    m = cpu_mesh(8)
    assert m.size == 8 and m.device == torch.device("cpu")
    assert T.make_mesh(devices=["cpu"]) == cpu_mesh(1)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        T.make_mesh(devices=[torch.device("cpu"), torch.device("meta")])
    _, At = both("laplacian_2d_16")
    if not torch.cuda.is_available():              # no default mesh without a GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.dist_solve(At, np.ones(256), method="cg")
    x, info = T.dist_solve(At, np.ones(256), method="cg", mesh=cpu_mesh(1))
    assert info.converged and x.shape == (256,)


def test_prepared_state_is_memoized():
    _, At = both("laplacian_2d_16")
    At = dataclasses.replace(At, data=At.data.copy())
    b = torch.ones(256, dtype=torch.float64)
    mesh = cpu_mesh()
    x1, i1 = T.dist_solve(At, b, pc="bjilu", mesh=mesh)
    entries = At._dist_cache
    assert len(entries) == 1
    first = next(iter(entries.values()))
    T.dist_solve(At, 2 * b, pc="bjilu", mesh=mesh)
    assert next(iter(entries.values())) is first
    for p in (1, 2, 4, 16, 32, 64, 128, 256):               # 8 more meshes: LRU bound 8
        T.dist_solve(At, b, mesh=cpu_mesh(p))
    assert len(At._dist_cache) == 8
    At.data[:] *= 2.0                                        # content change: rebuilt
    x2, i2 = T.dist_solve(At, b, pc="bjilu", mesh=mesh)
    assert i2.nits == i1.nits
    np.testing.assert_allclose(2 * x2.numpy(), x1.numpy(), rtol=1e-10)
