"""The classical AMG slice of lssp_tpu_torch (``amg/setup.py``,
``amg/cycle.py``, ``pc="amg"``, ``amg_solve``), the native AMG host
kernels and the hierarchy ordering (``amg/aggregate.py``) against lssp_tpu
on the CPU.

Host setups must be identical to JAX's: the port runs the same numpy and
native code, and takes the native path exactly when JAX does (the port's
``native.available`` is pinned to JAX's in every setup test, so a cold JAX
build that falls back to its oracles is matched, not skipped).  Cycles run
on the same hierarchy, carried across by ``interop.amg_from_jax``: 1e-12
relative in fp64, 1e-5 in fp32, and an (n, k) block against its k columns.
Solves: iteration counts within ±1 of JAX's and x within 1e-8 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu import native as jnative
from lssp_tpu.amg import aggregate as jagg
from lssp_tpu.amg import cycle as jcycle
from lssp_tpu.amg import sa as jsa
from lssp_tpu.amg import setup as jsetup
from lssp_tpu.parallel import dist_sa as jdist_sa
import lssp_tpu_torch as T
from lssp_tpu_torch import interop
from lssp_tpu_torch import native as tnative
from lssp_tpu_torch.amg import aggregate as tagg
from lssp_tpu_torch.amg import cycle as tcycle
from lssp_tpu_torch.amg import sa as tsa
from lssp_tpu_torch.amg import setup as tsetup

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def same_path(monkeypatch):
    """The port's native/oracle choice pinned to the JAX package's."""
    monkeypatch.setattr(tnative, "available", lambda: jnative.available())


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


def aniso(N, eps=1e-3):
    return both(T.sparse.anisotropic_poisson_2d(N, epsilon=eps).to_scipy())


def unstructured(n=600, seed=0):
    """A symmetric diagonally dominant matrix with no grid structure."""
    R = sp.random(n, n, density=6.0 / n, random_state=seed)
    R = -abs(R + R.T)
    d = np.asarray(abs(R).sum(axis=1)).ravel() + 1.0
    return (R + sp.diags(d)).tocsr()


def csr_equal(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return (X.shape == Y.shape and np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices) and np.array_equal(X.data, Y.data))


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# native wrappers
# ---------------------------------------------------------------------------

def _rap_case(seed=0, n=400, nc=90, with_b=True):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.03, random_state=seed).tocsr()
    A = (A + A.T + sp.eye(n)).tocsr()
    B = ((sp.random(n, n, density=0.012, random_state=seed + 1).tocsr() + sp.eye(n)).tocsr()
         if with_b else None)
    return A, B, rng.integers(0, nc, n), nc


@pytest.mark.parametrize("with_b", [True, False])
def test_native_rap_matches_jax(with_b):
    A, B, p0, nc = _rap_case(with_b=with_b)
    got = tnative.rap(A, B, p0, nc)
    if jnative.available():
        assert csr_equal(got, jnative.rap(A, B, p0, nc))
    else:                         # JAX's own route: the scipy oracle
        P0 = sp.csr_matrix((np.ones(A.shape[0]), p0, np.arange(A.shape[0] + 1)),
                           shape=(A.shape[0], nc))
        P = (B @ P0).tocsr() if B is not None else P0
        ref = (P.T @ A @ P).tocsr()
        d = abs(got - ref)
        assert (d.max() if d.nnz else 0.0) < 1e-12


def test_native_gersh_matches_jax():
    A, _, _, _ = _rap_case(5, with_b=False)
    dinv = 1.0 / A.diagonal()
    ref = jsetup.lambda_gershgorin(A, dinv)        # native or oracle, as JAX takes it
    got = tnative.gersh(A.indptr, A.data, dinv, A.shape[0])
    assert got == ref if jnative.available() else abs(got - ref) < 1e-12
    assert tsetup.lambda_gershgorin(A, dinv) == got


@pytest.mark.parametrize("tol", [0.08, 0.3])
def test_native_filter_lumped_matches_jax(tol, monkeypatch):
    A = sp.csr_matrix(T.sparse.anisotropic_poisson_2d(20, epsilon=0.05).to_scipy())
    A = (A @ A).tocsr()                           # a 13-point stencil with weak couplings
    A.sum_duplicates()                            # canonical: sorted, as the filters make it
    ref = jsa._filter_lumped(A.copy(), tol)
    assert csr_equal(tsa._filter_lumped(A.copy(), tol), ref)
    oip, oix, oax = tnative.filter_lumped(A.indptr, A.indices, A.data, A.shape[0], tol)
    assert csr_equal(sp.csr_matrix((oax, oix, oip), shape=A.shape), ref)
    monkeypatch.setattr(tnative, "available", lambda: False)     # the port's oracle
    assert csr_equal(tsa._filter_lumped(A.copy(), tol), ref)


def test_native_lump_pattern_matches_jax(monkeypatch):
    A = sp.csr_matrix(T.sparse.laplacian_2d(18).to_scipy())
    A = (A @ A @ A).tocsr()
    A.sum_duplicates()
    ref = jsa._lump_to_pattern(A.copy(), 18, 18, 1, 1)
    assert csr_equal(tsa._lump_to_pattern(A.copy(), 18, 18, 1, 1), ref)
    oip, oix, oax = tnative.lump_pattern(A.indptr, A.indices, A.data, A.shape[0], 18, 1, 1)
    assert csr_equal(sp.csr_matrix((oax, oix, oip), shape=A.shape), ref)
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert csr_equal(tsa._lump_to_pattern(A.copy(), 18, 18, 1, 1), ref)


def test_native_greedy_aggregate_matches_jax():
    A = unstructured(400, seed=3)
    virt = np.zeros(400, dtype=bool)
    virt[-7:] = True
    got = tnative.greedy_aggregate(A, A.T.tocsr(), 4, 0.08, virt)
    ref = jagg._bfs_ids(jagg._sym_strength(A, 0.08), 4, virt)     # JAX's oracle
    assert np.array_equal(got, ref)
    assert np.array_equal(tagg._bfs_ids(tagg._sym_strength(A, 0.08), 4, virt), ref)


# ---------------------------------------------------------------------------
# host setup
# ---------------------------------------------------------------------------

SETUPS = {
    "laplacian_2d_24": lambda: both(T.sparse.laplacian_2d(24).to_scipy()),
    "aniso_32": lambda: aniso(32),
    "laplacian_3d_9": lambda: both(T.sparse.laplacian_3d(9).to_scipy()),
    "unstructured_500": lambda: both(unstructured(500, seed=1)),
}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_amg_setup_identical(name, same_path):
    Aj, At = SETUPS[name]()
    hj, ht = jsetup.amg_setup(Aj), tsetup.amg_setup(At)
    assert len(hj.levels) == len(ht.levels) >= 2
    for lj, lt_ in zip(hj.levels, ht.levels):
        assert csr_equal(lj.A, lt_.A)
        assert (lj.P is None) == (lt_.P is None)
        if lj.P is not None:
            assert csr_equal(lj.P, lt_.P)
        assert np.array_equal(lj.dinv, lt_.dinv) and lj.lmax == lt_.lmax
    assert np.array_equal(hj.coarse_inv, ht.coarse_inv)
    assert hj.complexity() == ht.complexity()


# ---------------------------------------------------------------------------
# cycles on one hierarchy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hier_aniso():
    Aj, At = aniso(28)
    return Aj, At, jsetup.amg_setup(Aj)


CYCLES = [("chebyshev", 1), ("jacobi", 1), ("l1jacobi", 1), ("chebyshev", 2)]


@pytest.mark.parametrize("smoother,gamma", CYCLES)
def test_vcycle_matches_jax(hier_aniso, smoother, gamma):
    _, At, hier = hier_aniso
    n = At.shape[0]
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        hj = jcycle.build_device_amg(hier, dtype=np_dtype, smoother=smoother, gamma=gamma)
        ht = interop.amg_from_jax(hj)
        ref = np.asarray(jcycle.vcycle(hj, jnp.asarray(b, np_dtype)))
        got = tcycle.vcycle(ht, torch.from_numpy(b).to(dtype))
        assert got.dtype == dtype and rel(got, ref) <= TOL[dtype]
        # the port's own build equals the carried-across one
        own = tcycle.build_device_amg(hier, dtype=np_dtype, smoother=smoother, gamma=gamma,
                                      device="cpu")
        assert [type(l.A) for l in own.levels] == [type(l.A) for l in ht.levels]
        assert rel(tcycle.vcycle(own, torch.from_numpy(b).to(dtype)), ref) <= TOL[dtype]
    ht64 = interop.amg_from_jax(jcycle.build_device_amg(hier, smoother=smoother, gamma=gamma))
    B = torch.from_numpy(rng.standard_normal((n, 3)))
    Y = tcycle.vcycle(ht64, B)
    for c in range(3):
        assert rel(Y[:, c], tcycle.vcycle(ht64, B[:, c].contiguous())) <= 1e-12


def test_fmg_initial_matches_jax(hier_aniso):
    _, At, hier = hier_aniso
    b = np.random.default_rng(8).standard_normal(At.shape[0])
    hj = jcycle.build_device_amg(hier)
    ht = interop.amg_from_jax(hj)
    ref = np.asarray(jcycle.fmg_initial(hj, jnp.asarray(b)))
    assert rel(tcycle.fmg_initial(ht, torch.from_numpy(b)), ref) <= 1e-12
    B = torch.from_numpy(np.stack([b, 2 * b - 1], axis=1))
    Y = tcycle.fmg_initial(ht, B)
    assert rel(Y[:, 0], ref) <= 1e-12 and rel(Y[:, 1], tcycle.fmg_initial(
        ht, B[:, 1].contiguous())) <= 1e-12


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmg", [False, True])
def test_amg_solve_matches_jax(fmg):
    Aj, At = aniso(32)
    n = At.shape[0]
    xj, ij = J.amg.amg_solve(Aj, jnp.ones(n), rtol=1e-10, atol=0.0, fmg=fmg)
    xt, it = T.amg_solve(At, torch.ones(n, dtype=torch.float64), rtol=1e-10, atol=0.0, fmg=fmg)
    assert abs(it["nits"] - ij["nits"]) <= 1
    assert it["complexity"] == ij["complexity"]
    assert rel(xt, xj) <= 1e-8
    assert it["residual"] <= 1e-10 * np.sqrt(n) * 10


def _opts(mod, **kw):
    return mod.SolverOptions(**dict(dict(rtol=1e-9, atol=0.0, rbtol=0.0, maxit=400,
                                         restart=30), **kw))


@pytest.mark.parametrize("entry", ["solve", "solve_ir", "Solver"])
def test_solves_with_amg_match_jax(entry):
    Aj, At = aniso(28)
    n = At.shape[0]
    b = np.random.default_rng(3).standard_normal(n)
    if entry == "Solver":
        sj, st = J.Solver("gmres", "amg", options=_opts(J)), T.Solver("gmres", "amg",
                                                                       options=_opts(T))
        xj = sj.assemble(Aj, jnp.asarray(b)).solve()
        xt = st.assemble(At, torch.from_numpy(b)).solve()
        nj, nt = sj.nits, st.nits
    else:
        xj, ij = getattr(J, entry)(Aj, jnp.asarray(b), method="gmres", pc="amg",
                                   options=_opts(J))
        xt, it = getattr(T, entry)(At, torch.from_numpy(b), method="gmres", pc="amg",
                                   options=_opts(T))
        nj, nt = int(ij.nits), int(it.nits)
    assert abs(nt - nj) <= 1
    assert rel(xt, xj) <= 1e-8


def test_solve_multi_with_amg_matches_jax():
    Aj, At = aniso(24)
    B = np.random.default_rng(4).standard_normal((At.shape[0], 3))
    Xj, ij = J.solve_multi(Aj, jnp.asarray(B), method="cg", pc="amg", options=_opts(J))
    Xt, it = T.solve_multi(At, torch.from_numpy(B), method="cg", pc="amg", options=_opts(T))
    assert (np.abs(np.asarray(it.nits) - np.asarray(ij.nits)) <= 1).all()
    assert rel(Xt, Xj) <= 1e-8


# ---------------------------------------------------------------------------
# the hierarchy ordering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,g", [(600, 4), (517, 4), (300, 2)])
def test_hierarchy_perm_identical(n, g, same_path):
    A = unstructured(n, seed=n)
    Aj, At = both(A)
    pj = jagg.hierarchy_perm(Aj, g=g, coarse_size=32)
    pt = tagg.hierarchy_perm(At, g=g, coarse_size=32)
    assert np.array_equal(pj, pt) and np.array_equal(np.sort(pt), np.arange(n))
    assert tagg.planned_padded_size(n, 1, g, 32, 12) == \
        jdist_sa.planned_padded_size(n, 1, g, 32, 12)


def test_resolve_reorder_choice():
    from lssp_tpu.solvers import facade as jf
    from lssp_tpu_torch.solvers import facade as tf
    for pc, po in [("saamg", None), ("rsamg", None), ("amg", None), ("ilu0", None),
                   ("saamg", "grid"), ("saamg", "flat")]:
        jo = {None: None, "grid": J.PCOptions(saamg_grid=(4, 4)),
              "flat": J.PCOptions(saamg_grid=False)}[po]
        to = {None: None, "grid": T.PCOptions(saamg_grid=(4, 4)),
              "flat": T.PCOptions(saamg_grid=False)}[po]
        for reorder in ("auto", None, "rcm"):
            assert tf.resolve_reorder(pc, to, reorder) == jf.resolve_reorder(pc, jo, reorder)
    assert tf.resolve_reorder("saamg", None, "auto") == "hier:4:64:12"


def test_hier_ordering_through_solve_matches_jax(same_path):
    """saamg on an unstructured matrix: ``solve`` takes the hierarchy
    ordering (memoized with the prepared matrix, like RCM) and returns x in
    the user's order, as JAX does."""
    S = unstructured(700, seed=11)
    Aj, At = both(S)
    n = S.shape[0]
    b = np.random.default_rng(5).standard_normal(n)
    xj, ij = J.solve(Aj, jnp.asarray(b), method="gmres", pc="saamg", options=_opts(J))
    xt, it = T.solve(At, torch.from_numpy(b), method="gmres", pc="saamg", options=_opts(T))
    assert abs(int(it.nits) - int(ij.nits)) <= 1 and it.converged
    assert rel(xt, xj) <= 1e-8
    key = ("prepared", "hier:4:64:12", "cpu")
    perm = At._prepared_cache[key][2]
    assert perm is not None
    assert np.array_equal(perm.numpy(), jagg.hierarchy_perm(Aj, g=4, coarse_size=64))
    assert np.linalg.norm(b - S @ xt.numpy()) <= 1e-9 * np.linalg.norm(b) * 1.01
