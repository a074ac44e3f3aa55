"""The gather-free classical AMG slice of lssp_tpu_torch (``amg/rs.py``,
``pc="rsamg"``) against lssp_tpu on the CPU.

``rs_host_setup`` must give JAX's levels exactly (operators, P, group map,
offsets, kept mass), with the port's native/oracle choice pinned to JAX's;
the AggP transfers equal the dense P and Pᵀ; ``rs_vcycle`` and
``rs_fmg_initial`` run on one hierarchy carried across by
``interop.rs_from_jax`` (1e-12 fp64, 1e-5 fp32, a block against its
columns); solves hold JAX's count ±1 and x to 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu import native as jnative
from lssp_tpu.amg import rs as jrs
import lssp_tpu_torch as T
from lssp_tpu_torch import interop
from lssp_tpu_torch import native as tnative
from lssp_tpu_torch.amg import rs as trs

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def same_path(monkeypatch):
    """The port's native/oracle choice pinned to the JAX package's."""
    monkeypatch.setattr(tnative, "available", lambda: jnative.available())


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


def rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def csr_equal(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return (X.shape == Y.shape and np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices) and np.array_equal(X.data, Y.data))


def unstructured(n=500, seed=0):
    R = sp.random(n, n, density=6.0 / n, random_state=seed)
    R = -abs(R + R.T)
    d = np.asarray(abs(R).sum(axis=1)).ravel() + 1.0
    return (R + sp.diags(d)).tocsr()


CASES = {
    "laplacian_3d_10": (lambda: T.sparse.laplacian_3d(10).to_scipy(), {}),
    "aniso_2d_30": (lambda: T.sparse.anisotropic_poisson_2d(30).to_scipy(), {}),
    "flat_padded_501": (lambda: unstructured(501, seed=2), {"grid": False}),
    "flat_capped": (lambda: unstructured(400, seed=3), {"grid": False, "max_pdiags": 3}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rs_host_setup_identical(name):
    build, kw = CASES[name]
    Aj, At = both(build())
    assert trs.detect_grid3(At) == jrs.detect_grid3(Aj)
    hj = jrs.rs_host_setup(Aj, coarse_size=24, **kw)
    ht = trs.rs_host_setup(At, coarse_size=24, **kw)
    assert hj.n_top == ht.n_top and len(hj.levels) == len(ht.levels) >= 2
    for a, b in zip(hj.levels, ht.levels):
        assert csr_equal(a.A, b.A) and csr_equal(a.P, b.P)
        assert np.array_equal(a.grp, b.grp) and np.array_equal(a.dinv, b.dinv)
        assert (a.g, a.agg, a.offsets, a.lmax, a.kept_mass, a.zero_rows) == \
            (b.g, b.agg, b.offsets, b.lmax, b.kept_mass, b.zero_rows)
    assert csr_equal(hj.A_coarse, ht.A_coarse)
    if name == "flat_capped":
        assert min(l.kept_mass for l in ht.levels) < 1.0
    if name == "flat_padded_501":
        assert ht.levels[0].A.shape[0] == 504


@pytest.mark.parametrize("name", ["laplacian_3d_10", "flat_padded_501"])
def test_aggp_transfers_equal_dense_p(name):
    build, kw = CASES[name]
    _, At = both(build())
    hier = trs.rs_host_setup(At, coarse_size=24, **kw)
    rng = np.random.default_rng(1)
    for lev in hier.levels:
        P = trs.to_aggp(lev.P, lev.grp, lev.g, lev.agg, lev.offsets)
        Pt = trs.AggP(P.offsets, torch.from_numpy(P.data), P.g, P.agg, P.shape)
        n, M = P.shape
        ec, r = rng.standard_normal(M), rng.standard_normal(n)
        assert rel(trs.aggp_prolong(Pt, torch.from_numpy(ec)), lev.P @ ec) <= 1e-13
        assert rel(trs.aggp_restrict(Pt, torch.from_numpy(r)), lev.P.T @ r) <= 1e-13
        E = rng.standard_normal((M, 2))
        assert rel(trs.aggp_prolong(Pt, torch.from_numpy(E)), lev.P @ E) <= 1e-13
        R2 = rng.standard_normal((n, 2))
        assert rel(trs.aggp_restrict(Pt, torch.from_numpy(R2)), lev.P.T @ R2) <= 1e-13


@pytest.fixture(scope="module")
def lap3d():
    return both(T.sparse.laplacian_3d(8).to_scipy())


@pytest.mark.parametrize("smoother,gamma", [("chebyshev", 1), ("jacobi", 1), ("chebyshev", 2)])
def test_rs_vcycle_matches_jax(lap3d, smoother, gamma):
    Aj, At = lap3d
    n = At.shape[0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    hier = jrs.rs_host_setup(Aj, coarse_size=24)
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        hj = jrs.build_device_rs(hier, dtype=np_dtype, smoother=smoother, gamma=gamma)
        ht = interop.rs_from_jax(hj)
        ref = np.asarray(jrs.rs_vcycle(hj, jnp.asarray(b, np_dtype)))
        got = trs.rs_vcycle(ht, torch.from_numpy(b).to(dtype))
        assert got.dtype == dtype and rel(got, ref) <= TOL[dtype]
        own = trs.build_device_rs(trs.rs_host_setup(At, coarse_size=24), dtype=np_dtype,
                                  smoother=smoother, gamma=gamma, device="cpu")
        assert rel(trs.rs_vcycle(own, torch.from_numpy(b).to(dtype)), ref) <= TOL[dtype]
    ht = interop.rs_from_jax(jrs.build_device_rs(hier, smoother=smoother, gamma=gamma))
    B = torch.from_numpy(rng.standard_normal((n, 3)))
    Y = trs.rs_vcycle(ht, B)
    for c in range(3):
        assert rel(Y[:, c], trs.rs_vcycle(ht, B[:, c].contiguous())) <= 1e-12


@pytest.mark.parametrize("name", ["laplacian_3d_10", "flat_padded_501"])
def test_rs_fmg_initial_matches_jax(name):
    build, kw = CASES[name]
    Aj, _ = both(build())
    hj = jrs.build_device_rs(jrs.rs_host_setup(Aj, coarse_size=24, **kw))
    ht = interop.rs_from_jax(hj)
    b = np.random.default_rng(6).standard_normal(Aj.shape[0])
    ref = np.asarray(jrs.rs_fmg_initial(hj, jnp.asarray(b)))
    assert rel(trs.rs_fmg_initial(ht, torch.from_numpy(b)), ref) <= 1e-12
    B = torch.from_numpy(np.stack([b, 1 - b], axis=1))
    Y = trs.rs_fmg_initial(ht, B)
    assert rel(Y[:, 0], ref) <= 1e-12
    assert rel(Y[:, 1], trs.rs_fmg_initial(ht, B[:, 1].contiguous())) <= 1e-12


def _opts(mod, **kw):
    return mod.SolverOptions(**dict(dict(rtol=1e-9, atol=0.0, rbtol=0.0, maxit=400), **kw))


@pytest.mark.parametrize("entry", ["solve", "solve_ir", "Solver", "solve_multi"])
def test_solves_with_rsamg_match_jax(lap3d, entry):
    Aj, At = lap3d
    n = At.shape[0]
    rng = np.random.default_rng(7)
    if entry == "solve_multi":
        B = rng.standard_normal((n, 2))
        Xj, ij = J.solve_multi(Aj, jnp.asarray(B), method="cg", pc="rsamg", options=_opts(J))
        Xt, it = T.solve_multi(At, torch.from_numpy(B), method="cg", pc="rsamg",
                               options=_opts(T))
        assert (np.abs(np.asarray(it.nits) - np.asarray(ij.nits)) <= 1).all()
        assert rel(Xt, Xj) <= 1e-8
        return
    b = rng.standard_normal(n)
    if entry == "Solver":
        sj, st = J.Solver("cg", "rsamg", options=_opts(J)), T.Solver("cg", "rsamg",
                                                                      options=_opts(T))
        xj = sj.assemble(Aj, jnp.asarray(b)).solve()
        xt = st.assemble(At, torch.from_numpy(b)).solve()
        nj, nt = sj.nits, st.nits
    else:
        xj, ij = getattr(J, entry)(Aj, jnp.asarray(b), method="cg", pc="rsamg",
                                   options=_opts(J))
        xt, it = getattr(T, entry)(At, torch.from_numpy(b), method="cg", pc="rsamg",
                                   options=_opts(T))
        nj, nt = int(ij.nits), int(it.nits)
    assert abs(nt - nj) <= 1
    assert rel(xt, xj) <= 1e-8


def test_setup_rs_pc_on_a_capped_hierarchy():
    """An interpolation capped at 3 offsets a level: the PC's apply equals
    JAX's."""
    Aj, At = both(unstructured(400, seed=3))
    kw = dict(amg_max_pdiags=3, amg_coarse_size=24)
    Mj = jrs.setup_rs_pc(Aj, J.PCOptions(**kw).resolved())
    Mt = trs.setup_rs_pc(At, T.PCOptions(**kw).resolved(), device="cpu")
    assert Mt.name == "amg"
    b = np.random.default_rng(8).standard_normal(At.shape[0])
    assert rel(Mt(torch.from_numpy(b)), np.asarray(Mj(jnp.asarray(b)))) <= 1e-12
