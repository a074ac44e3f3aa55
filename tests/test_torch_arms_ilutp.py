"""ILUTP and ARMS of lssp_tpu_torch against lssp_tpu on the CPU.

``ilutp_factor`` (the pure-Python heap loop, a copy of JAX's) gives L, U
and perm bit for bit; the ``ilutp`` apply, exact and at 6 Neumann sweeps
(K2's plain version here), and its M⁻ᵀ agree with JAX's to 1e-12 in fp64.
ARMS: the independent sets (JAX's ``default_rng(0)`` tie break), the level
matrices and the coarse LU bit for bit; the apply on JAX's own state
(``interop.arms_from_jax``) and on the port's to 1e-12; solves JAX's ±1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.pc import arms as jarms
from lssp_tpu.pc import ilu_host as jilu
from lssp_tpu.pc import lu_host as jlu
import lssp_tpu_torch as T
from lssp_tpu_torch import interop
from lssp_tpu_torch.pc import arms as tarms
from lssp_tpu_torch.pc import ilu_host as tilu


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.CSR.from_scipy(S), T.CSR.from_scipy(S)


def tiny_diagonal(n=128):
    """``tests/test_ilu.py: test_robust_on_tiny_diagonal``'s matrix: 50 diagonal
    entries of 1e-14, a sub- and a superdiagonal; its pivoted factors are
    exact, and their triangular solves grow exponentially with n, so it
    stays at JAX's n = 128."""
    d = np.r_[np.full(50, 1e-14), np.ones(n - 50)]
    return (sp.diags(d) + 0.5 * sp.diags(np.ones(n - 1), 1)
            + 0.3 * sp.diags(np.ones(n - 1), -1)).tocsr()


ILUTP_CELLS = {
    "random_40_exact": (lambda: (sp.random(40, 40, density=0.25, random_state=3, format="csr")
                                 + sp.eye(40) * 0.01).tocsr(), dict(tol=0.0, p=10**6, permtol=0.5)),
    "tiny_diagonal_128": (tiny_diagonal, {}),
    "convdiff_16": (lambda: J.sparse.convection_diffusion_2d(16, beta=20.0).to_scipy(), {}),
    "random_120": (lambda: (sp.random(120, 120, density=0.05, random_state=8, format="csr")
                            + sp.diags(np.r_[np.full(30, 1e-12), np.ones(90)])).tocsr(),
                   dict(permtol=0.2)),
}


@pytest.mark.parametrize("name", sorted(ILUTP_CELLS))
def test_ilutp_factor_bitwise(name):
    gen, kw = ILUTP_CELLS[name]
    Aj, At = both(gen())
    Lj, Uj, pj = jilu.ilutp_factor(Aj, **kw)
    Lt, Ut, pt = tilu.ilutp_factor(At, **kw)
    for Fj, Ft in ((Lj, Lt), (Uj, Ut)):
        for a in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(np.asarray(getattr(Fj, a)), np.asarray(getattr(Ft, a)))
    np.testing.assert_array_equal(pj, pt)
    if name == "random_40_exact":
        LU = (Lt.todense() + np.eye(40)) @ Ut.todense()
        np.testing.assert_allclose(LU, At.todense()[:, pt], rtol=1e-10, atol=1e-12)
        assert (pt != np.arange(40)).any()


@pytest.mark.parametrize("sweeps", [0, 6])
@pytest.mark.parametrize("name", ["convdiff_16", "random_120"])
def test_ilutp_apply_matches_jax(name, sweeps):
    """M⁻¹ and M⁻ᵀ against JAX's ``ilutp``, fp64, 1e-12 (6 sweeps: the port's
    K2 plan and its transposed plan in their plain versions, JAX's XLA
    Neumann sweeps); a block column by column."""
    Aj, At = both(ILUTP_CELLS[name][0]())
    Mj = J.pc.setup(Aj, "ilutp", J.PCOptions(ilu_sweeps=sweeps, transpose=True))
    Mt = T.pc.setup(At, "ilutp", T.PCOptions(ilu_sweeps=sweeps, transpose=True), device="cpu")
    assert Mt.name.startswith("ilutp[")
    rng = np.random.default_rng(0)
    r, R = rng.standard_normal(At.shape[0]), rng.standard_normal((At.shape[0], 3))
    for ft, fj in ((Mt, Mj), (Mt.t, Mj.t)):
        ref = np.asarray(fj(jnp.asarray(r)))
        np.testing.assert_allclose(ft(torch.from_numpy(r)).numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
        Z = ft(torch.from_numpy(R)).numpy()
        for c in range(3):
            np.testing.assert_allclose(Z[:, c], ft(torch.from_numpy(R[:, c].copy())).numpy(),
                                       rtol=1e-13, atol=1e-13 * np.abs(Z).max())


@pytest.mark.parametrize("sweeps,limit", [(0, 5), (6, 16)])
def test_ilutp_pivot_path(sweeps, limit):
    """JAX's tiny-diagonal system (n = 128) through ``solve`` gmres fp64:
    the pivoting moves columns, and the count is JAX's ±1 (exact: ≤ 5, JAX's
    own bound; 6 sweeps: JAX 14)."""
    Aj, At = both(tiny_diagonal())
    perm = tilu.ilutp_factor(At)[2]
    assert (perm != np.arange(128)).sum() > 0
    xj, ij = J.solve(Aj, jnp.ones(128), method="gmres", pc="ilutp",
                     options=J.SolverOptions(maxit=200), pc_options=J.PCOptions(ilu_sweeps=sweeps))
    xt, it = T.solve(At, torch.ones(128, dtype=torch.float64), method="gmres", pc="ilutp",
                     options=T.SolverOptions(maxit=200), pc_options=T.PCOptions(ilu_sweeps=sweeps))
    assert it.converged and abs(it.nits - int(ij.nits)) <= 1 and it.nits <= limit
    assert np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) < 1e-6


def test_ilutp_solves():
    """gmres and bicg (M⁻ᵀ) with ilutp on the convection-diffusion 24²
    against JAX's counts ±1, exact factors."""
    Aj, At = both(J.sparse.convection_diffusion_2d(24, beta=20.0).to_scipy())
    for method in ("gmres", "bicg"):
        o = dict(maxit=400, restart=30)
        _, ij = J.solve(Aj, jnp.ones(576), method=method, pc="ilutp",
                        options=J.SolverOptions(**o), pc_options=J.PCOptions(ilu_sweeps=0))
        xt, it = T.solve(At, torch.ones(576, dtype=torch.float64), method=method, pc="ilutp",
                         options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=0))
        assert it.converged and abs(it.nits - int(ij.nits)) <= 1, (method, it.nits, ij.nits)


# -- ARMS ----------------------------------------------------------------------

ARMS_GENS = {
    "laplacian_2d_32": lambda M: M.sparse.laplacian_2d(32),
    "convdiff_24": lambda M: M.sparse.convection_diffusion_2d(24, beta=20.0),
    "aniso_24": lambda M: M.sparse.anisotropic_poisson_2d(24, 0.01),
}


def _jax_arms(Aj, monkeypatch):
    """JAX's ``arms_setup`` with its coarse ``SpLU`` captured."""
    seen = []
    orig = jlu.splu_factor
    monkeypatch.setattr(jlu, "splu_factor", lambda *a, **k: seen.append(orig(*a, **k)) or seen[-1])
    levels, coarse = jarms.arms_setup(Aj)
    monkeypatch.undo()
    return levels, coarse, seen[-1]


def _arr(F):
    return np.asarray(F.indptr), np.asarray(F.indices), np.asarray(F.data), F.shape


@pytest.mark.parametrize("name", sorted(ARMS_GENS))
def test_arms_setup_bitwise(name, monkeypatch):
    """The F/C splits, B⁻¹ and the E / F level matrices equal JAX's; the
    coarse LU (RCM) equals JAX's factor."""
    Aj, At = ARMS_GENS[name](J), ARMS_GENS[name](T)
    fj, cj = jarms._greedy_dd_mis(Aj)
    ft, ct = tarms._greedy_dd_mis(At)
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_array_equal(cj, ct)
    lj, _, cfj = _jax_arms(Aj, monkeypatch)
    seen = []
    from lssp_tpu_torch.pc import lu_host as tlu
    orig = tlu.splu_factor
    monkeypatch.setattr(tlu, "splu_factor", lambda *a, **k: seen.append(orig(*a, **k)) or seen[-1])
    lt, _ = tarms.arms_setup(At)
    assert len(lt) == len(lj) >= 1
    for a, b in zip(lj, lt):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        for Ej, Et in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(np.asarray(Ej.cols), Et.cols.numpy())
            np.testing.assert_array_equal(np.asarray(Ej.data), Et.data.numpy())
            assert tuple(Ej.shape) == tuple(Et.shape)
    cft = seen[-1]
    for Fj, Ft in ((cfj.L, cft.L), (cfj.U, cft.U)):
        for a in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(np.asarray(getattr(Fj, a)), np.asarray(getattr(Ft, a)))
    np.testing.assert_array_equal(cfj.perm_in, cft.perm_in)


def test_fine_block_is_diagonal():
    A = T.sparse.convection_diffusion_2d(16, beta=30.0)
    f_idx, c_idx = tarms._greedy_dd_mis(A)
    sub = A.to_scipy()[f_idx][:, f_idx]
    assert abs(sub - sp.diags(sub.diagonal())).sum() == 0.0
    assert len(f_idx) + len(c_idx) == A.shape[0]


@pytest.mark.parametrize("name", sorted(ARMS_GENS))
def test_arms_apply_matches_jax(name, monkeypatch):
    """The apply on JAX's own state (``arms_from_jax``) and on the port's
    setup against JAX's ``_arms_apply``, fp64, 1e-12; an (n, k) block column
    by column; no M⁻ᵀ, as in JAX."""
    Aj, At = ARMS_GENS[name](J), ARMS_GENS[name](T)
    lj, cj, cfj = _jax_arms(Aj, monkeypatch)
    levels = [(np.asarray(f), np.asarray(c), np.asarray(d),
               (np.asarray(E.cols), np.asarray(E.data), E.shape),
               (np.asarray(F.cols), np.asarray(F.data), F.shape)) for f, c, d, E, F in lj]
    coarse = interop.splu_from_jax(_arr(cfj.L), _arr(cfj.U), cfj.perm_in, cfj.perm_out)
    st = interop.arms_from_jax(levels, coarse)
    Mt = T.pc.setup(At, "arms", device="cpu")
    rng = np.random.default_rng(0)
    r, R = rng.standard_normal(At.shape[0]), rng.standard_normal((At.shape[0], 2))
    ref = np.asarray(jax.jit(lambda v: jarms._arms_apply((lj, cj), v))(jnp.asarray(r)))
    tol = dict(rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(tarms._arms_apply(st, torch.from_numpy(r)).numpy(), ref, **tol)
    np.testing.assert_allclose(Mt(torch.from_numpy(r)).numpy(), ref, **tol)
    Z = Mt(torch.from_numpy(R)).numpy()
    for c in range(2):
        np.testing.assert_allclose(Z[:, c], Mt(torch.from_numpy(R[:, c].copy())).numpy(),
                                   rtol=1e-13, atol=1e-13 * np.abs(Z).max())
    with pytest.raises(ValueError, match="no transpose apply"):
        Mt.t(torch.from_numpy(r))


@pytest.mark.parametrize("name", sorted(ARMS_GENS))
def test_arms_solve_matches_jax(name):
    """``tests/test_block_pcs.py: test_converges_fast``: gmres(60) + arms,
    the port's count JAX's ±1 (≤ 10) and relres < 1e-5."""
    Aj, At = ARMS_GENS[name](J), ARMS_GENS[name](T)
    n = At.shape[0]
    o = dict(maxit=200, restart=60)
    xj, ij = J.solve(Aj, jnp.ones(n), method="gmres", pc="arms", options=J.SolverOptions(**o))
    xt, it = T.solve(At, torch.ones(n, dtype=torch.float64), method="gmres", pc="arms",
                     options=T.SolverOptions(**o))
    assert it.converged and it.nits <= 10 and abs(it.nits - int(ij.nits)) <= 1
    assert np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) < 1e-5


def test_arms_small_matrix_is_direct_and_no_transpose():
    """Below ``coarse_size`` the hierarchy is empty, a direct LU (≤ 2 its);
    a transpose method with arms raises, as in JAX."""
    A = T.sparse.laplacian_2d(8)
    b = torch.ones(64, dtype=torch.float64)
    x, info = T.solve(A, b, method="gmres", pc="arms")
    assert info.nits <= 2
    with pytest.raises(ValueError, match="no transpose apply"):
        T.solve(T.sparse.laplacian_2d(16), torch.ones(256, dtype=torch.float64), method="bicg",
                pc="arms")


def test_arms_multi_and_ir():
    """``solve_multi`` gmres + arms column by column (each its single count
    ±1), and ``solve_ir`` gmres(30) + arms on the convection-diffusion 24²
    against JAX's inner count ±2."""
    Aj, At = ARMS_GENS["convdiff_24"](J), ARMS_GENS["convdiff_24"](T)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((576, 3)))
    o = T.SolverOptions(maxit=200, restart=60)
    X, info = T.solve_multi(At, B, method="gmres", pc="arms", options=o)
    singles = [T.solve(At, B[:, c], method="gmres", pc="arms", options=o)[1].nits
               for c in range(3)]
    assert np.all(np.abs(info.nits - np.array(singles)) <= 1) and info.converged.all()
    oo = dict(rtol=1e-8, atol=0, rbtol=0, restart=30)
    _, ij = J.solve_ir(Aj, jnp.ones(576), method="gmres", pc="arms", options=J.SolverOptions(**oo))
    xt, it = T.solve_ir(At, torch.ones(576, dtype=torch.float64), method="gmres", pc="arms",
                        options=T.SolverOptions(**oo), device="cpu")
    assert it.converged and abs(it.nits - int(ij.nits)) <= 2, (it.nits, int(ij.nits))
