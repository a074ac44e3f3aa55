"""The structured smoothed-aggregation slice of lssp_tpu_torch
(``amg/sa.py``, ``ops/tridiag.py``, ``pc="saamg"``) against lssp_tpu on
the CPU.

``sa_host_levels`` must give JAX's levels exactly in every aggregation mode
(x, y and box semicoarsening on grids, flat ranges with identity padding),
with the port's native/oracle choice pinned to JAX's.  The packed device
levels (A, B and C = Bᵀ derived on the device) equal JAX's arrays.  Cycles
run on one hierarchy carried across by ``interop.sa_from_jax``: 1e-12
relative in fp64, 1e-5 in fp32, and an (n, k) block against its columns.
Solves hold JAX's count ±1 and x to 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu import native as jnative
from lssp_tpu.amg import sa as jsa
from lssp_tpu.ops import tridiag as jtri
import lssp_tpu_torch as T
from lssp_tpu_torch import interop
from lssp_tpu_torch import native as tnative
from lssp_tpu_torch.amg import sa as tsa
from lssp_tpu_torch.ops import tridiag as ttri

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def same_path(monkeypatch):
    """The port's native/oracle choice pinned to the JAX package's."""
    monkeypatch.setattr(tnative, "available", lambda: jnative.available())


def grid_op(N, cx, cy):
    """cx·(-∂xx) + cy·(-∂yy) on an N×N row-major grid (5-point)."""
    T1 = sp.diags([-np.ones(N - 1), 2 * np.ones(N), -np.ones(N - 1)], [-1, 0, 1])
    I = sp.eye(N)
    A = (cx * sp.kron(I, T1) + cy * sp.kron(T1, I)).tocsr()
    A.sort_indices()
    return A


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def csr_equal(X, Y):
    if X is None or Y is None:
        return X is None and Y is None
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return (X.shape == Y.shape and np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices) and np.array_equal(X.data, Y.data))


# (matrix, grid argument, the first level's expected aggregation mode)
MODES = {
    "x": (lambda: grid_op(20, 1.0, 0.01), None, "x"),
    "y": (lambda: grid_op(20, 0.01, 1.0), None, "y"),
    "box_ragged": (lambda: grid_op(15, 1.0, 1.0), None, "box"),
    "flat_padded": (lambda: grid_op(15, 1.0, 0.3), False, None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sa_host_levels_identical(mode):
    build, grid, first = MODES[mode]
    Aj, At = both(build())
    assert tsa.detect_grid(At) == jsa.detect_grid(Aj)
    gj = jsa.detect_grid(Aj) if grid is None else None
    kw = dict(g=4, coarse_size=16, smooth_levels=12 if grid is None else 2, grid=gj,
              pattern_radius=(2, 2) if grid is None else None)
    lj, Acj, nj = jsa.sa_host_levels(Aj, **kw)
    lt, Act, nt = tsa.sa_host_levels(At, **kw)
    assert nj == nt and len(lj) == len(lt) >= 2
    assert (lt[0][6] or (None,))[0] == first
    for a, b in zip(lj, lt):
        Aa, Ba, Ca, da, la, nca, aga = a
        Ab, Bb, Cb, db, lb, ncb, agb = b
        assert csr_equal(Aa, Ab) and csr_equal(Ba, Bb) and csr_equal(Ca, Cb)
        assert np.array_equal(da, db) and la == lb and nca == ncb and aga == agb
    assert csr_equal(Acj, Act)
    if grid is False:                               # 225 rows padded to a multiple of 4
        assert lt[0][0].shape[0] == 228


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sa_setup_device_levels_identical(dtype):
    """A, B and C (C = Bᵀ from B's device data) equal JAX's packed arrays,
    and C is exactly the host transpose of the lumped B."""
    Aj, At = both(grid_op(24, 1.0, 0.05))
    hj = jsa.sa_setup(Aj, coarse_size=16, dtype=dtype)
    ht = tsa.sa_setup(At, coarse_size=16, dtype=dtype, device="cpu")
    levels, _, _ = tsa.sa_host_levels(At, coarse_size=16, smooth_levels=12,
                                      grid=tsa.detect_grid(At), host_c=True)
    assert len(hj.levels) == len(ht.levels)
    for lj, lt_, host in zip(hj.levels, ht.levels, levels):
        for name in ("A", "B", "C"):
            Mj, Mt = getattr(lj, name), getattr(lt_, name)
            assert Mj.offsets == Mt.offsets
            assert np.array_equal(np.asarray(Mj.data), Mt.data.numpy())
        C_host = T.sparse.csr_to_dia(T.CSR.from_scipy(host[2]), max_diags=96, dtype=dtype)
        assert C_host.offsets == lt_.C.offsets and torch.equal(C_host.data, lt_.C.data)
        assert lt_.agg == lj.agg and lt_.n_next == lj.n_next
    assert np.array_equal(np.asarray(hj.coarse_inv), ht.coarse_inv.numpy())


@pytest.fixture(scope="module")
def aniso_case():
    return both(T.sparse.anisotropic_poisson_2d(32, epsilon=0.01).to_scipy())


@pytest.mark.parametrize("smoother,gamma", [("chebyshev", 1), ("jacobi", 1), ("line", 1),
                                            ("chebyshev", 2)])
def test_sa_vcycle_matches_jax(aniso_case, smoother, gamma):
    Aj, At = aniso_case
    n = At.shape[0]
    rng = np.random.default_rng(9)
    b = rng.standard_normal(n)
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        hj = jsa.sa_setup(Aj, coarse_size=16, smoother=smoother, gamma=gamma, dtype=np_dtype)
        ht = interop.sa_from_jax(hj)
        ref = np.asarray(jsa.sa_vcycle(hj, jnp.asarray(b, np_dtype)))
        got = tsa.sa_vcycle(ht, torch.from_numpy(b).to(dtype))
        assert got.dtype == dtype and rel(got, ref) <= TOL[dtype]
        own = tsa.sa_setup(At, coarse_size=16, smoother=smoother, gamma=gamma, dtype=np_dtype,
                           device="cpu")
        assert rel(tsa.sa_vcycle(own, torch.from_numpy(b).to(dtype)), ref) <= TOL[dtype]
    B = torch.from_numpy(rng.standard_normal((n, 3)))
    ht = interop.sa_from_jax(jsa.sa_setup(Aj, coarse_size=16, smoother=smoother, gamma=gamma))
    Y = tsa.sa_vcycle(ht, B)
    for c in range(3):
        assert rel(Y[:, c], tsa.sa_vcycle(ht, B[:, c].contiguous())) <= 1e-12


def test_sa_vcycle_flat_padded_block_matches_jax():
    """Flat levels (identity padding at every level) on a block: rows are
    padded, each column as JAX's vector cycle."""
    Aj, At = both(grid_op(15, 1.0, 0.3))
    hj = jsa.sa_setup(Aj, coarse_size=16, grid=False)
    ht = interop.sa_from_jax(hj)
    assert ht.levels[0].A.shape[0] == 228 and ht.n_top == 225
    B = np.random.default_rng(10).standard_normal((225, 2))
    Y = tsa.sa_vcycle(ht, torch.from_numpy(B))
    for c in range(2):
        assert rel(Y[:, c], np.asarray(jsa.sa_vcycle(hj, jnp.asarray(B[:, c])))) <= 1e-12


@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_pcr_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    dl = -rng.uniform(0.1, 1.0, n)
    du = -rng.uniform(0.1, 1.0, n)
    dl[0] = du[-1] = 0.0
    if n > 8:                       # a decoupled line boundary
        dl[n // 2] = du[n // 2 - 1] = 0.0
    d = 2.5 + rng.uniform(0, 1, n)
    b = rng.standard_normal(n)
    ref = np.asarray(jtri.pcr_solve(*(jnp.asarray(v) for v in (dl, d, du, b))))
    t = [torch.from_numpy(v) for v in (dl, d, du)]
    got = ttri.pcr_solve(*t, torch.from_numpy(b))
    assert rel(got, ref) <= 1e-12
    Tm = sp.diags([dl[1:], d, du[:-1]], [-1, 0, 1]).toarray() if n > 1 else np.diag(d)
    assert np.abs(Tm @ got.numpy() - b).max() <= 1e-12 * np.abs(b).max() * 10
    Bk = torch.from_numpy(np.stack([b, -3 * b, b ** 2], axis=1))
    Y = ttri.pcr_solve(*t, Bk)
    for c in range(3):
        assert rel(Y[:, c], ttri.pcr_solve(*t, Bk[:, c].contiguous())) <= 1e-14


def test_line_jacobi_sweeps_matches_jax(aniso_case):
    Aj, At = aniso_case
    Dj = J.sparse.csr_to_dia(Aj)
    Dt = T.sparse.csr_to_dia(At)
    trij = jtri.tridiag_parts(Dj)
    trit = ttri.tridiag_parts(Dt)
    for a, c in zip(trij, trit):
        assert np.array_equal(np.asarray(a), c.numpy())
    rng = np.random.default_rng(12)
    b, x = rng.standard_normal(At.shape[0]), rng.standard_normal(At.shape[0])
    ref = np.asarray(jtri.line_jacobi_sweeps(
        tuple(jnp.asarray(a) for a in trij), lambda v: J.ops.spmv(Dj, v), jnp.asarray(x),
        jnp.asarray(b), 3))
    got = ttri.line_jacobi_sweeps(trit, lambda v: T.ops.spmv(Dt, v), torch.from_numpy(x),
                                  torch.from_numpy(b), 3)
    assert rel(got, ref) <= 1e-12


def _opts(mod, **kw):
    return mod.SolverOptions(**dict(dict(rtol=1e-9, atol=0.0, rbtol=0.0, maxit=400,
                                         restart=30), **kw))


@pytest.mark.parametrize("entry", ["solve", "solve_ir", "Solver"])
def test_solves_with_saamg_match_jax(aniso_case, entry):
    Aj, At = aniso_case
    b = np.random.default_rng(13).standard_normal(At.shape[0])
    if entry == "Solver":
        sj, st = J.Solver("gmres", "saamg", options=_opts(J)), T.Solver("gmres", "saamg",
                                                                         options=_opts(T))
        xj = sj.assemble(Aj, jnp.asarray(b)).solve()
        xt = st.assemble(At, torch.from_numpy(b)).solve()
        nj, nt = sj.nits, st.nits
    else:
        xj, ij = getattr(J, entry)(Aj, jnp.asarray(b), method="gmres", pc="saamg",
                                   options=_opts(J))
        xt, it = getattr(T, entry)(At, torch.from_numpy(b), method="gmres", pc="saamg",
                                   options=_opts(T))
        nj, nt = int(ij.nits), int(it.nits)
    assert abs(nt - nj) <= 1
    assert rel(xt, xj) <= 1e-8


@pytest.mark.parametrize("multi", ["solve_multi", "solve_ir_multi"])
def test_multi_with_saamg_matches_jax(aniso_case, multi):
    Aj, At = aniso_case
    B = np.random.default_rng(14).standard_normal((At.shape[0], 3))
    method = "cg" if multi == "solve_multi" else "blockgmres"
    Xj, ij = getattr(J, multi)(Aj, jnp.asarray(B), method=method, pc="saamg", options=_opts(J))
    Xt, it = getattr(T, multi)(At, torch.from_numpy(B), method=method, pc="saamg",
                               options=_opts(T))
    assert (np.abs(np.asarray(it.nits) - np.asarray(ij.nits)) <= 1).all()
    assert rel(Xt, Xj) <= 1e-8
    S = At.to_scipy()
    assert (np.linalg.norm(B - S @ Xt.numpy(), axis=0)
            <= 1e-9 * np.linalg.norm(B, axis=0) * 1.01).all()
