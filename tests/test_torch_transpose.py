"""The transpose path of lssp_tpu_torch against lssp_tpu on the CPU:
``spmv_t`` on every format, the transposed Neumann plan of K2, the M⁻ᵀ
applies, the transpose methods bicg, qmr, cgnr / cgn and lsqr (single-rhs,
per-column batched and under ``solve_ir``), rectangular lsqr, and the
facade's transpose rules.

Tolerances: products and applies to 1e-12 in fp64 (another summation
order at most); counts JAX's ±1 with x to 1e-8 relative at the same
number of iterations (``tests/test_torch_krylov_common.py: parity``).

JAX's DIA/HYB ``spmv_t`` sizes its result by the row count, so it is
wrong on a tall matrix (ROADMAP C property 11): the port's tall products
are held against scipy, and JAX only on the ELL of the same matrix, the
route it can take.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops import trisolve as jtri
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
from lssp_tpu.pc.ilu_host import ilut_factor as j_ilut
import lssp_tpu_torch as T
from lssp_tpu_torch.ops import trisolve as ttri
from lssp_tpu_torch.ops.neumann import (band_reads, neumann_apply_plain, plan_fused_neumann,
                                        plan_fused_neumann_t, wavefront_schedule)
from lssp_tpu_torch.ops.spmv import spmv, spmv_t
from lssp_tpu_torch.pc.ilu_host import iluk_factor as t_iluk
from lssp_tpu_torch.pc.ilu_host import ilut_factor as t_ilut
from lssp_tpu_torch.solvers.base import operator_t, pc_transpose
from test_torch_neumann import _check_schedule, _emulate, _host_factor, _strayed

# the module (``lssp_tpu.ops`` re-exports a function of its name)
jspmv = importlib.import_module("lssp_tpu.ops.spmv")
TMETHODS = ["bicg", "qmr", "cgnr", "lsqr"]


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


def nearly_banded(n1d=20, nstray=60, seed=3):
    return _strayed(T, n1d, nstray, seed).to_scipy()


def tall(N):
    """[L; 0.1·I], L = laplacian_2d(N): Tikhonov-regularised Poisson."""
    L = T.sparse.laplacian_2d(N).to_scipy()
    S = sp.vstack([L, 0.1 * sp.eye(L.shape[0])]).tocsr()
    S.sort_indices()
    return S


# ---- spmv_t on every format -------------------------------------------------

def _formats(Sj, St, fmt):
    """(JAX container, port container) of one execution format."""
    if fmt == "csr":
        return Sj, St.to("cpu")
    if fmt == "ell":
        return J.sparse.csr_to_ell(Sj), T.sparse.csr_to_ell(St)
    if fmt == "dia":
        return J.sparse.csr_to_dia(Sj, max_diags=64), T.sparse.csr_to_dia(St, max_diags=64)
    if fmt == "hyb":
        return J.sparse.csr_to_hyb(Sj), T.sparse.csr_to_hyb(St)
    bj, bt = J.sparse.csr_to_bsr(Sj, 2), T.sparse.csr_to_bsr(St, 2)
    if fmt == "bsr":
        return bj, bt.to("cpu")
    return J.sparse.convert.bsr_to_bdia(bj, max_diags=64, fill=10.0), \
        T.sparse.bsr_to_bdia(bt, max_diags=64, fill=10.0)


SPMV_T = [("random", "csr"), ("random", "ell"), ("convdiff", "dia"), ("strayed", "hyb"),
          ("convdiff", "bsr"), ("convdiff", "bdia"), ("strayed", "ell")]


@pytest.mark.parametrize("name,fmt", SPMV_T)
def test_spmv_t_matches_jax(name, fmt):
    """(n,) against JAX's ``spmv_t`` and scipy; an (n, k) block column by
    column against the vector."""
    S = {"random": lambda: J.sparse.random_sparse(96, 6, seed=3).to_scipy(),
         "convdiff": lambda: J.sparse.convection_diffusion_2d(12, beta=10.0).to_scipy(),
         "strayed": nearly_banded}[name]()
    Aj, At = _formats(*both(S), fmt)
    n = S.shape[0]
    rng = np.random.default_rng(1)
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    y = spmv_t(At, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jspmv.spmv_t(Aj, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, S.T @ x, rtol=1e-12, atol=1e-12)
    Y = spmv_t(At, torch.from_numpy(X)).numpy()
    for c in range(3):
        np.testing.assert_allclose(Y[:, c], spmv_t(At, torch.from_numpy(X[:, c].copy())).numpy(),
                                   rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("fmt", ["dia", "hyb", "ell", "auto"])
def test_spmv_t_tall_against_scipy(fmt):
    """On the tall [L; 0.1·I] every format's transpose returns A.shape[1]
    entries equal to scipy's (JAX's DIA/HYB transpose returns A.shape[0]:
    the defect the port does not copy); the forward product too.  The
    ELL result also equals JAX's ELL one.  ``to_device_format`` gives the
    tall system the format JAX gives it, HYB."""
    S = tall(16)
    Aj, At = both(S)
    D = {"dia": lambda: T.sparse.csr_to_dia(At, max_diags=64), "hyb": lambda: T.sparse.csr_to_hyb(At),
         "ell": lambda: T.sparse.csr_to_ell(At),
         "auto": lambda: T.sparse.to_device_format(At, device="cpu")}[fmt]()
    if fmt == "auto":
        assert isinstance(D, T.HYB) and type(J.sparse.to_device_format(Aj)).__name__ == "HYB"
    rng = np.random.default_rng(2)
    y, x = rng.standard_normal(S.shape[0]), rng.standard_normal(S.shape[1])
    got = spmv_t(D, torch.from_numpy(y)).numpy()
    assert got.shape == (S.shape[1],)
    np.testing.assert_allclose(got, S.T @ y, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(spmv(D, torch.from_numpy(x)).numpy(), S @ x, rtol=1e-13,
                               atol=1e-13)
    Y = rng.standard_normal((S.shape[0], 2))
    np.testing.assert_allclose(spmv_t(D, torch.from_numpy(Y)).numpy(), S.T @ Y, rtol=1e-13,
                               atol=1e-13)
    if fmt == "ell":
        np.testing.assert_allclose(
            got, np.asarray(jspmv.spmv_t(J.sparse.csr_to_ell(Aj), jnp.asarray(y))),
            rtol=1e-13, atol=1e-13)
    if fmt == "dia":
        bad = np.asarray(jspmv.spmv_t(J.sparse.csr_to_dia(Aj, max_diags=64), jnp.asarray(y)))
        assert bad.shape == (S.shape[0],)          # JAX's square assumption


def test_wide_matrix_goes_to_ell():
    """A wide matrix whose offsets pass its row count has no band: ELL."""
    S = tall(8).T.tocsr()
    D = T.sparse.to_device_format(T.CSR.from_scipy(S), device="cpu")
    assert isinstance(D, T.ELL)
    y = np.random.default_rng(3).standard_normal(S.shape[0])
    np.testing.assert_allclose(spmv_t(D, torch.from_numpy(y)).numpy(), S.T @ y, rtol=1e-13,
                               atol=1e-13)


def test_spmv_t_refuses_callables_and_host_csr():
    with pytest.raises(TypeError, match="t_op"):
        spmv_t(lambda v: v, torch.ones(4))
    with pytest.raises(TypeError, match="device CSR"):
        spmv_t(T.sparse.laplacian_2d(4), torch.ones(16, dtype=torch.float64))


# ---- the transposed Neumann plan --------------------------------------------

def _pairs(kind):
    """(JAX factors, port factors): bit-identical host factors."""
    if kind == "ilu0":
        return (j_iluk(J.sparse.convection_diffusion_2d(20, beta=10.0), level=0),
                t_iluk(T.sparse.convection_diffusion_2d(20, beta=10.0), level=0))
    if kind == "iluk_strayed":
        return j_iluk(_strayed(J, 24, 120), level=1), t_iluk(_strayed(T, 24, 120), level=1)
    return (j_ilut(J.sparse.convection_diffusion_2d(16, beta=20.0)),
            t_ilut(T.sparse.convection_diffusion_2d(16, beta=20.0)))


@pytest.mark.parametrize("sweeps", [2, 6])
@pytest.mark.parametrize("kind", ["ilu0", "iluk_strayed", "ilut"])
def test_transposed_plan_matches_neumann_ilu_apply_t(kind, sweeps):
    """The transposed plan's plain apply (K2's plain version) against JAX's
    ``neumann_ilu_apply_t`` and the port's own, fp64, to 1e-12, on (n,)
    and on an (n, k) block; the factors keep K2's orientation (phase 0
    strictly lower, phase 1 strictly upper)."""
    (Lj, Uj), (Lt, Ut) = _pairs(kind)
    plan = plan_fused_neumann_t(Lt, Ut, sweeps)
    n = plan.n
    for F, lower in ((plan.L, True), (plan.U, False)):
        offs = np.asarray(F.offsets)
        assert (offs < 0).all() if lower else (offs > 0).all()
    r = np.random.default_rng(5).standard_normal(n)
    got = neumann_apply_plain(plan, torch.from_numpy(r)).numpy()
    ref = np.asarray(jtri.neumann_ilu_apply_t(jtri.make_neumann_tri(Lj, Uj, sweeps=sweeps),
                                              jnp.asarray(r)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    own = ttri.neumann_ilu_apply_t(ttri.make_neumann_tri(Lt, Ut, sweeps=sweeps),
                                   torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, own, rtol=1e-12, atol=1e-12)
    R = np.random.default_rng(6).standard_normal((n, 3))
    G = neumann_apply_plain(plan, torch.from_numpy(R)).numpy()
    for c in range(3):
        np.testing.assert_allclose(G[:, c], neumann_apply_plain(
            plan, torch.from_numpy(R[:, c].copy())).numpy(), rtol=1e-14, atol=1e-14)


def test_transposed_plan_is_the_forward_plan_moved():
    """The transposed plan holds the forward plan's values (fp32: the
    same rounding), 1/diag bitwise, and the same reach."""
    L, U = t_iluk(_strayed(T, 24, 120), level=1)
    for dtype in (torch.float32, torch.float64):
        f, t = (p(L, U, 6, dtype=dtype) for p in (plan_fused_neumann, plan_fused_neumann_t))
        assert torch.equal(f.invdiag, t.invdiag) and f.reach == t.reach

        def values(F):
            v = [F.band.flatten()] + ([F.stray_vals] if F.stray_ptr is not None else [])
            v = torch.cat(v)
            return torch.sort(v[v != 0]).values
        assert torch.equal(values(f.L), values(t.U)) and torch.equal(values(f.U), values(t.L))


@pytest.mark.parametrize("kind", ["ilu0", "iluk_strayed"])
def test_transposed_plan_wavefront(kind):
    """K2's schedule for the transposed plan, replayed level by level in
    numpy (levels in random order within the in-flight window): every
    wait covers what a level reads, no deadlock, and the result equals
    the plain apply."""
    _, (L, U) = _pairs(kind)
    plan = plan_fused_neumann_t(L, U, 4)
    w = wavefront_schedule(plan.n, plan.reach, 4, 32, 6, ncols=2, offsets=band_reads(plan))
    _check_schedule(w, [_host_factor(plan.L), _host_factor(plan.U)])
    R = np.random.default_rng(8).standard_normal((plan.n, 2))
    got = _emulate(w, plan, R, window=w.grid, seed=3)
    np.testing.assert_allclose(got, neumann_apply_plain(plan, torch.from_numpy(R)).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sweeps", [0, 6])
@pytest.mark.parametrize("pc", ["ilu0", "iluk", "ilut", "jacobi", "none"])
def test_pc_transpose_apply_matches_jax(pc, sweeps):
    """M.t of every transposable PC of this slice's solves against JAX's,
    exact and 6 sweeps, 1e-12; a block column by column."""
    S = J.sparse.convection_diffusion_2d(16, beta=10.0).to_scipy()
    Aj, At = both(S)
    Mj = J.pc.setup(Aj, pc, J.PCOptions(ilu_sweeps=sweeps, transpose=True))
    Mt = T.pc.setup(At, pc, T.PCOptions(ilu_sweeps=sweeps, transpose=True), device="cpu")
    r = np.random.default_rng(9).standard_normal(S.shape[0])
    np.testing.assert_allclose(Mt.t(torch.from_numpy(r)).numpy(),
                               np.asarray(Mj.t(jnp.asarray(r))), rtol=1e-12, atol=1e-12)
    R = np.random.default_rng(10).standard_normal((S.shape[0], 2))
    Z = Mt.t(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(Z[:, 1], Mt.t(torch.from_numpy(R[:, 1].copy())).numpy(),
                               rtol=1e-14, atol=1e-14)


# ---- the transpose methods --------------------------------------------------

NONSYM = both(J.sparse.convection_diffusion_2d(24, beta=10.0).to_scipy())
SYM = both(J.sparse.laplacian_2d(32).to_scipy())
CASES = [(m, p) for m in ("bicg", "qmr") for p in ("none", "jacobi", "iluk", "ilut", "ssor")] \
    + [(m, p) for m in ("cgnr", "cgn", "lsqr") for p in ("none", "iluk")]


@pytest.mark.parametrize("method,pc", CASES, ids=[f"{m}+{p}" for m, p in CASES])
def test_solve_matches_jax(method, pc):
    """``tests/test_solvers_extra.py``'s systems (bicg / qmr on the
    convection-diffusion 24², cgnr / lsqr on the Laplacian 32²), b = 1,
    maxit 3000, ILU exact: counts JAX's ±1, x to 1e-8 at the same count,
    the true residual within the reference's 4·tol."""
    Aj, At = NONSYM if method in ("bicg", "qmr") else SYM
    n = At.shape[0]

    def jsolve(**kw):
        return J.solve(Aj, jnp.ones(n), method=method, pc=pc,
                       options=J.SolverOptions(maxit=kw.get("maxit", 3000)),
                       pc_options=J.PCOptions(ilu_sweeps=0))

    def tsolve(**kw):
        return T.solve(At, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                       options=T.SolverOptions(maxit=kw.get("maxit", 3000)),
                       pc_options=T.PCOptions(ilu_sweeps=0))
    xj, ij = jsolve()
    xt, it = tsolve()
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 1, (it.nits, int(ij.nits))
    res = np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy())
    assert res <= 4 * max(1e-7 * np.sqrt(n), 1e-7)
    if it.nits > int(ij.nits):
        xt, _ = tsolve(maxit=int(ij.nits))
    elif it.nits < int(ij.nits):
        xj, _ = jsolve(maxit=it.nits)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


@pytest.mark.parametrize("method", TMETHODS)
def test_batched_matches_jax_vmap(method):
    """``solve_multi`` per column (ILU(k) exact) against JAX's vmapped
    solve on 3 seeded columns: each column's count JAX's ±1, x to 1e-8;
    a zero column stops at 0 iterations with x exactly 0."""
    Aj, At = NONSYM if method in ("bicg", "qmr") else SYM
    n = At.shape[0]
    B = np.random.default_rng(7).standard_normal((n, 3)) * np.array([1.0, 0.0, 1.0])
    Xj, ij = J.solve_multi(Aj, jnp.asarray(B), method=method, pc="iluk",
                           options=J.SolverOptions(maxit=3000),
                           pc_options=J.PCOptions(ilu_sweeps=0))
    Xt, it = T.solve_multi(At, torch.from_numpy(B), method=method, pc="iluk",
                           options=T.SolverOptions(maxit=3000),
                           pc_options=T.PCOptions(ilu_sweeps=0))
    nj = np.asarray(ij.nits)
    assert it.nits.shape == (3,) and np.all(np.abs(it.nits - nj) <= 1), (it.nits, nj)
    assert it.converged.all() and it.nits[1] == 0
    assert torch.equal(Xt[:, 1], torch.zeros(n, dtype=torch.float64))
    Xj = np.asarray(Xj)
    for c in (0, 2):
        np.testing.assert_allclose(Xt[:, c].numpy(), Xj[:, c],
                                   rtol=0, atol=1e-6 * np.abs(Xj[:, c]).max())


@pytest.mark.parametrize("method", TMETHODS)
def test_batched_columns_are_single_solves(method):
    """Each column of the per-column form takes its own single solve's
    count, at 6 Neumann sweeps (the transposed plan on a block)."""
    At = (NONSYM if method in ("bicg", "qmr") else SYM)[1]
    n = At.shape[0]
    B = np.random.default_rng(11).standard_normal((n, 2))
    o = T.SolverOptions(maxit=3000)
    pco = T.PCOptions(ilu_sweeps=6)
    _, info = T.solve_multi(At, torch.from_numpy(B), method=method, pc="ilu0", options=o,
                            pc_options=pco)
    singles = [T.solve(At, torch.from_numpy(B[:, c].copy()), method=method, pc="ilu0",
                       options=o, pc_options=pco)[1].nits for c in range(2)]
    assert np.all(np.abs(info.nits - np.array(singles)) <= 1), (info.nits, singles)


@pytest.fixture
def port_inner_cap(monkeypatch):
    """JAX's ``_inner_plan`` with the port's inner cap for the normal-
    equation methods (the whole maxit; JAX caps them at 200, under which
    cgnr does not converge at 128³: ``solvers/refine.py: _inner_plan``)."""
    import dataclasses
    from lssp_tpu.solvers import refine
    plan = refine._inner_plan

    def patched(method, opts, inner_rtol):
        fn, inner_opts = plan(method, opts, inner_rtol)
        if method.lower() in ("cgnr", "cgn", "lsqr"):
            inner_opts = dataclasses.replace(inner_opts, maxit=opts.maxit)
        return fn, inner_opts
    monkeypatch.setattr(refine, "_inner_plan", patched)


@pytest.mark.parametrize("method", TMETHODS)
def test_solve_ir_matches_jax(method, port_inner_cap):
    """``solve_ir`` (fp32 inner, ILU(0) at 6 sweeps: the transposed plan's
    plain version against JAX's transposed sweeps) to rtol 1e-8: total
    inner counts JAX's ±max(2, 5 %) under the port's inner policy, true
    residual."""
    Aj, At = NONSYM if method in ("bicg", "qmr") else SYM
    n = At.shape[0]
    kw = dict(method=method, pc="ilu0")
    xj, ij = J.solve_ir(Aj, jnp.ones(n), options=J.SolverOptions(rtol=1e-8, atol=0, rbtol=0),
                        pc_options=J.PCOptions(ilu_sweeps=6), **kw)
    xt, it = T.solve_ir(At, torch.ones(n, dtype=torch.float64),
                        options=T.SolverOptions(rtol=1e-8, atol=0, rbtol=0),
                        pc_options=T.PCOptions(ilu_sweeps=6), **kw)
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= max(2, int(0.05 * int(ij.nits))), \
        (it.nits, int(ij.nits))
    assert np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) <= 1e-8 * np.sqrt(n) * 1.01


def test_lsqr_rectangular_least_squares():
    """``tests/test_facade_validation.py``'s tall system: lsqr through
    ``solve`` reaches the least-squares solution, as JAX's does; x lives
    in the column space (and a given x0 must too)."""
    rng = np.random.default_rng(0)
    As = (sp.random(24, 10, density=0.4, random_state=0)
          + sp.vstack([sp.eye(10), sp.csr_matrix((14, 10))])).tocsr()
    b = rng.standard_normal(24)
    opts = dict(maxit=300, rtol=1e-12, atol=1e-12)
    x, info = T.solve(T.CSR.from_scipy(As), torch.from_numpy(b), method="lsqr",
                      options=T.SolverOptions(**opts))
    xs, *_ = np.linalg.lstsq(As.toarray(), b, rcond=None)
    assert x.shape == (10,)
    np.testing.assert_allclose(x.numpy(), xs, atol=1e-9)
    xj, ij = J.solve(J.sparse.CSR.from_scipy(As), jnp.asarray(b), method="lsqr",
                     options=J.SolverOptions(**opts))
    assert abs(info.nits - int(ij.nits)) <= 1
    # from the least-squares x, b − Ax0 ⟂ range(A): the correction stays ~0
    x2, _ = T.solve(T.CSR.from_scipy(As), torch.from_numpy(b), x0=x, method="lsqr",
                    options=T.SolverOptions(**opts))
    np.testing.assert_allclose(x2.numpy(), xs, atol=1e-9)
    with pytest.raises(ValueError, match="columns"):
        T.solve(T.CSR.from_scipy(As), torch.from_numpy(b), x0=torch.zeros(24, dtype=torch.float64),
                method="lsqr")
    with pytest.raises(ValueError, match="SQUARE"):
        T.solve(T.CSR.from_scipy(As), torch.from_numpy(b), method="cgnr")


@pytest.mark.parametrize("fmt", ["auto", "dia", "ell"])
def test_lsqr_tall_every_format(fmt):
    """lsqr on the tall [L; 0.1·I] (b = A·1, rtol 1e-8) gives the
    least-squares answer on every format the port can run it in (the
    format it chooses, HYB, and DIA and ELL): the same count as JAX through
    ELL, ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ ≤ 1e-6 and x = 1 to 1e-6."""
    S = tall(24)
    Aj, At = both(S)
    b = S @ np.ones(S.shape[1])
    D = {"auto": At, "dia": T.sparse.csr_to_dia(At, max_diags=64),
         "ell": T.sparse.csr_to_ell(At)}[fmt]
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=5000)
    x, info = T.solve(D, torch.from_numpy(b), method="lsqr", options=T.SolverOptions(**o),
                      device="cpu")
    xj, ij = J.solve(J.sparse.csr_to_ell(Aj), jnp.asarray(b), method="lsqr",
                     options=J.SolverOptions(**o))
    assert info.converged and abs(info.nits - int(ij.nits)) <= 1
    r = b - S @ x.numpy()
    assert np.linalg.norm(S.T @ r) <= 1e-6 * np.linalg.norm(S.T @ b)
    np.testing.assert_allclose(x.numpy(), np.ones(S.shape[1]), atol=1e-6)


def test_lsqr_tall_solve_ir_and_multi():
    """The rectangular lsqr through ``solve_ir`` (fp32 inner, x in the
    column space) and ``solve_multi`` (each column its single solve)."""
    S = tall(24)
    At = T.CSR.from_scipy(S)
    b = S @ np.ones(S.shape[1])
    o = T.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=5000)
    x, info = T.solve_ir(At, torch.from_numpy(b), method="lsqr", options=o)
    assert info.converged and x.shape == (S.shape[1],)
    np.testing.assert_allclose(x.numpy(), np.ones(S.shape[1]), atol=1e-6)
    B = np.stack([b, 2.0 * S @ np.linspace(0.0, 1.0, S.shape[1])], axis=1)
    X, minfo = T.solve_multi(At, torch.from_numpy(B), method="lsqr", options=o)
    assert X.shape == (S.shape[1], 2) and minfo.converged.all()
    for c in range(2):
        _, single = T.solve(At, torch.from_numpy(B[:, c].copy()), method="lsqr", options=o)
        assert abs(minfo.nits[c] - single.nits) <= 1


# ---- the facade's transpose rules -------------------------------------------

def test_memo_gmres_then_bicg():
    """A gmres ``solve_ir`` and then a bicg ``solve_ir`` on the same
    container: the second finds no forward-only PC under its key (the
    transpose flag is part of the memo key), at 6 sweeps and exact."""
    At = T.sparse.convection_diffusion_2d(16, beta=10.0)
    b = torch.ones(At.shape[0], dtype=torch.float64)
    o = T.SolverOptions(rtol=1e-8, atol=0, rbtol=0)
    for sweeps in (6, 0):
        pco = T.PCOptions(ilu_sweeps=sweeps)
        _, i1 = T.solve_ir(At, b, method="gmres", pc="ilu0", options=o, pc_options=pco)
        x, i2 = T.solve_ir(At, b, method="bicg", pc="ilu0", options=o, pc_options=pco)
        assert i1.converged and i2.converged
        M = T.prepare_ir(At, method="bicg", pc="ilu0", pc_options=pco, device="cpu")[4]
        assert M.apply_t_fn is not None
        M.t(torch.ones(At.shape[0], dtype=torch.float32))


def test_transpose_method_with_amg_raises():
    Aj, At = NONSYM
    with pytest.raises(ValueError, match="no transpose apply"):
        T.solve(At, torch.ones(At.shape[0], dtype=torch.float64), method="bicg", pc="amg")


def test_solver_lifecycle_injects_transpose():
    """``Solver.assemble`` builds M⁻ᵀ for a transpose method (exact and 6
    sweeps) as JAX's does; ``solve_multi`` through it too."""
    Aj, At = NONSYM
    n = At.shape[0]
    for sweeps in (0, 6):
        s = T.Solver(method="bicg", pc="iluk", pc_options=T.PCOptions(ilu_sweeps=sweeps),
                     device="cpu").assemble(At, torch.ones(n, dtype=torch.float64))
        s.solve()
        assert s.info.converged and s.M.apply_t_fn is not None
        js = J.solvers.facade.Solver(method="bicg", pc="iluk",
                                     pc_options=J.PCOptions(ilu_sweeps=sweeps)
                                     ).assemble(Aj, jnp.ones(n))
        js.solve()
        if sweeps == 0:
            assert abs(s.nits - int(js.info.nits)) <= 1
    X = s.solve_multi(torch.ones(n, 2, dtype=torch.float64))
    assert X.shape == (n, 2) and s.info.converged.all()


def test_bare_callable_pc():
    """A bare callable M without ``.t`` is refused by a transpose method;
    with ``M.t = M`` (a symmetric M) it runs, as in JAX."""
    At = T.sparse.convection_diffusion_2d(8, beta=5.0)
    b = torch.ones(At.shape[0], dtype=torch.float64)
    with pytest.raises(TypeError, match="transpose"):
        T.solve(At, b, method="bicg", M=lambda r: r)

    def M(r):
        return 0.5 * r
    M.t = M
    x, info = T.solve(At, b, method="bicg", M=M)
    assert info.converged
    assert np.linalg.norm(b.numpy() - At.to_scipy() @ x.numpy()) < 1e-5
    assert pc_transpose(None)(b) is b
    with pytest.raises(TypeError, match="t_op"):
        operator_t(lambda v: v)


def test_operator_with_transpose_attribute():
    """A matrix-free operator runs the transpose methods through its
    ``t_op`` (``parallel.dist_ops.OpWithTranspose``)."""
    from lssp_tpu_torch.parallel.dist_ops import OpWithTranspose
    At = T.sparse.convection_diffusion_2d(12, beta=5.0)
    D = T.sparse.to_device_format(At, device="cpu")
    op = OpWithTranspose(lambda v: spmv(D, v), lambda v: spmv_t(D, v))
    b = torch.ones(At.shape[0], dtype=torch.float64)
    for method in TMETHODS:
        x, info = T.solve(op, b, method=method, options=T.SolverOptions(maxit=3000))
        x2, info2 = T.solve(At, b, method=method, options=T.SolverOptions(maxit=3000))
        assert info.converged and info.nits == info2.nits and torch.equal(x, x2)


def test_warm_start():
    At = NONSYM[1]
    b = torch.ones(At.shape[0], dtype=torch.float64)
    o = T.SolverOptions(maxit=3000)
    x1, _ = T.solve(At, b, method="bicg", pc="iluk", options=o)
    _, info = T.solve(At, b, x0=x1, method="bicg", pc="iluk", options=o)
    assert info.nits <= 2


def test_user_pc():
    """The ``user`` PC: ``user_setup(A)`` builds the state, ``user_apply``
    applies it; as JAX's, no transpose apply is installed."""
    At = T.sparse.laplacian_2d(12)
    d = T.sparse.diagonal(At)
    opts = T.PCOptions(user_setup=lambda A: torch.from_numpy(1.0 / T.sparse.diagonal(A)),
                       user_apply=lambda st, r: st * r)
    M = T.pc.setup(At, "user", opts, device="cpu")
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(144))
    assert M.name == "user" and torch.equal(M(r), torch.from_numpy(1.0 / d) * r)
    with pytest.raises(ValueError, match="no transpose apply"):
        M.t(r)
    x, info = T.solve(At, torch.ones(144, dtype=torch.float64), method="cg", pc="user",
                      pc_options=opts)
    xj, ij = J.solve(J.sparse.laplacian_2d(12), jnp.ones(144), method="cg", pc="user",
                     pc_options=J.PCOptions(user_setup=lambda A: jnp.asarray(
                         1.0 / J.sparse.diagonal(A)), user_apply=lambda st, r: st * r))
    assert info.converged and info.nits == int(ij.nits)
    with pytest.raises(ValueError, match="user_apply"):
        T.pc.setup(At, "user", T.PCOptions(), device="cpu")
