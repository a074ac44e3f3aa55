"""The relaxation, polynomial and Schwarz preconditioners of lssp_tpu_torch
(``pc/relax.py``: ssor, sor, gs; ``pc/poly.py``: poly, chebyshev;
``pc/schwarz.py``: ras, schwarz, bjacobi) against lssp_tpu on the CPU.

Applies (M⁻¹ and, where installed, M⁻ᵀ) to 1e-12 in fp64, exact and at 6
Neumann sweeps (K2's plain version and its transposed plan); an (n, k)
block equals its columns.  Solves: counts JAX's ±1, x to 1e-8 at the same
count.  JAX's ssor / sor / gs factors of a float32 matrix come out
float64, so its ``solve_ir`` with them stops with a dtype error (ROADMAP C
property 12); the port keeps the matrix's dtype, and its ``solve_ir`` is
held against JAX's with that clamp repaired in the test (``monkeypatch``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.pc import relax as jrelax
import lssp_tpu_torch as T
from lssp_tpu_torch.ops.neumann import FusedNeumann

PCS = [("ssor", dict(omega=1.2)), ("sor", dict(omega=1.3)), ("gs", {}), ("poly", {}),
       ("chebyshev", dict(poly_degree=5)), ("ras", dict(num_blocks=5, schwarz_overlap=3)),
       ("schwarz", {}), ("bjacobi", dict(num_blocks=3))]
TRANSPOSED = {"ssor", "sor", "gs", "poly", "chebyshev"}


def both(S):
    S = sp.csr_matrix(S)
    S.sort_indices()
    return J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)


CD = both(J.sparse.convection_diffusion_2d(20, beta=5.0).to_scipy())


@pytest.mark.parametrize("sweeps", [0, 6])
@pytest.mark.parametrize("pc,kw", PCS, ids=[p for p, _ in PCS])
def test_apply_matches_jax(pc, kw, sweeps):
    """M⁻¹ (and M⁻ᵀ for the PCs that install it) against JAX's on the
    convection-diffusion 20², fp64, 1e-12; the block apply column by
    column; the Schwarz PCs install no M⁻ᵀ, as JAX's."""
    Aj, At = CD
    tr = pc in TRANSPOSED
    Mj = J.pc.setup(Aj, pc, J.PCOptions(ilu_sweeps=sweeps, transpose=tr, **kw))
    Mt = T.pc.setup(At, pc, T.PCOptions(ilu_sweeps=sweeps, transpose=tr, **kw), device="cpu")
    rng = np.random.default_rng(0)
    r, R = rng.standard_normal(At.shape[0]), rng.standard_normal((At.shape[0], 3))
    applies = [(Mt, Mj)] + ([(Mt.t, Mj.t)] if tr else [])
    for ft, fj in applies:
        np.testing.assert_allclose(ft(torch.from_numpy(r)).numpy(), np.asarray(fj(jnp.asarray(r))),
                                   rtol=1e-12, atol=1e-12)
        Z = ft(torch.from_numpy(R)).numpy()
        for c in range(3):
            np.testing.assert_allclose(Z[:, c], ft(torch.from_numpy(R[:, c].copy())).numpy(),
                                       rtol=1e-14, atol=1e-14)
    if not tr:
        with pytest.raises(ValueError, match="no transpose apply"):
            Mt.t(torch.from_numpy(r))


@pytest.mark.parametrize("pc,omega", [("ssor", 1.0), ("ssor", 1.5), ("gs", 1.0), ("sor", 1.3)])
def test_exact_apply_is_the_dense_solve(pc, omega):
    """``tests/test_block_pcs.py: test_exact_apply``: M⁻¹r against a dense
    solve with M = (D + ωL)D⁻¹(D + ωU)/(ω(2−ω)) or D/ω + L, exact and its
    transpose against Mᵀ."""
    A = T.sparse.convection_diffusion_2d(12, beta=3.0)
    Ad = A.todense()
    D, L, U = np.diag(np.diag(Ad)), np.tril(Ad, -1), np.triu(Ad, 1)
    M = T.pc.setup(A, pc, T.PCOptions(omega=omega, ilu_sweeps=0, transpose=True), device="cpu")
    if pc == "ssor":
        Md = (D + omega * L) @ np.linalg.inv(D) @ (D + omega * U) / (omega * (2 - omega))
    else:
        Md = D / (1.0 if pc == "gs" else omega) + L
    r = np.linspace(1.0, 2.0, A.shape[0])
    np.testing.assert_allclose(M(torch.from_numpy(r)).numpy(), np.linalg.solve(Md, r),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.t(torch.from_numpy(r)).numpy(), np.linalg.solve(Md.T, r),
                               rtol=1e-10, atol=1e-12)


def test_ssor_symmetric_for_symmetric_a():
    """A nonconstant diagonal (the column scaling of the unit-L factor) and
    a symmetric A: M_SSOR is symmetric, so M.t = M (exact and 6 sweeps)."""
    n = 30
    d = np.linspace(1.0, 10.0, n)
    A = T.CSR.from_scipy(sp.diags([np.full(n - 1, -0.3), d, np.full(n - 1, -0.3)],
                                  [-1, 0, 1]).tocsr())
    r = torch.from_numpy(np.linspace(1.0, 2.0, n))
    for sweeps in (0, 6):
        M = T.pc.setup(A, "ssor", T.PCOptions(omega=1.2, ilu_sweeps=sweeps, transpose=True),
                       device="cpu")
        np.testing.assert_allclose(M.t(r).numpy(), M(r).numpy(), rtol=1e-12)


def test_plans():
    """On the K2 path: ssor and sor carry a forward and a transposed plan;
    sor's U is its diagonal alone, so its phase-1 factor is one all-zero
    band; ras's local solve is one plan over B·E stacked rows."""
    A = T.sparse.laplacian_2d(16)
    sor = T.pc.setup(A, "sor", T.PCOptions(omega=1.3, ilu_sweeps=6, transpose=True),
                     device="cpu")
    fwd, tr = sor.state
    assert isinstance(fwd, FusedNeumann) and isinstance(tr, FusedNeumann)
    assert fwd.U.offsets == (0,) and float(fwd.U.band.abs().max()) == 0.0
    assert tr.L.offsets == (0,) and tr.U.offsets == (1, 16)
    ras = T.pc.setup(A, "ras", T.PCOptions(num_blocks=4, schwarz_overlap=2, ilu_sweeps=6),
                     device="cpu")
    assert isinstance(ras.state, FusedNeumann) and ras.state.n == 4 * (64 + 4)


def test_fp32_factors_keep_the_matrix_dtype(monkeypatch):
    """A float32 matrix gives float32 relaxation factors and plans (JAX's
    come out float64, and its fp32 ``solve_ir`` with them raises), and
    the port's ``solve_ir`` with ssor takes the count of JAX's with the
    clamp repaired, ±max(2, 5 %)."""
    Aj, At = CD
    M = T.pc.setup(At.astype(np.float32), "ssor", T.PCOptions(ilu_sweeps=6, transpose=True),
                   device="cpu")
    assert M.state[0].dtype == torch.float32 and M.state[1].dtype == torch.float32
    n = At.shape[0]
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0)
    with pytest.raises(TypeError):
        J.solve_ir(Aj, jnp.ones(n), method="bicg", pc="ssor", options=J.SolverOptions(**o),
                   pc_options=J.PCOptions(ilu_sweeps=6))
    safe = jrelax._safe_diag
    monkeypatch.setattr(jrelax, "_safe_diag", lambda d: safe(d).astype(np.asarray(d).dtype))
    Aj = J.sparse.CSR.from_scipy(Aj.to_scipy())     # no memo of the failed setup
    for method in ("bicg", "gmres"):
        _, ij = J.solve_ir(Aj, jnp.ones(n), method=method, pc="ssor",
                           options=J.SolverOptions(**o), pc_options=J.PCOptions(ilu_sweeps=6))
        x, it = T.solve_ir(At, torch.ones(n, dtype=torch.float64), method=method, pc="ssor",
                           options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=6))
        assert it.converged and bool(ij.converged)
        assert abs(it.nits - int(ij.nits)) <= max(2, int(0.05 * int(ij.nits)))


SOLVES = [("cg", "ssor", "lap", {}), ("cg", "poly", "lap", dict(poly_degree=8)),
          ("cg", "chebyshev", "lap", {}), ("gmres", "sor", "cd", dict(omega=1.3)),
          ("gmres", "gs", "cd", {}), ("gmres", "ras", "cd", dict(num_blocks=8, schwarz_overlap=8)),
          ("gmres", "schwarz", "cd", dict(num_blocks=4)), ("gmres", "bjacobi", "cd", {}),
          ("bicg", "ssor", "cd", {}), ("qmr", "poly", "lap", {}), ("cgnr", "gs", "cd", {}),
          ("lsqr", "ssor", "lap", {})]
SYSTEMS = {"lap": both(J.sparse.laplacian_2d(32).to_scipy()),
           "cd": both(J.sparse.convection_diffusion_2d(32, beta=20.0).to_scipy())}


@pytest.mark.parametrize("method,pc,system,kw", SOLVES,
                         ids=[f"{m}+{p}" for m, p, _, _ in SOLVES])
def test_solve_matches_jax(method, pc, system, kw):
    """``solve`` (fp64, exact local solves, b = 1, restart 60, maxit 3000):
    counts JAX's ±1 and x to 1e-8 at the same count."""
    Aj, At = SYSTEMS[system]
    n = At.shape[0]

    def run(M, b, **extra):
        return M.solve(Aj if M is J else At, b, method=method, pc=pc,
                       options=M.SolverOptions(restart=60, maxit=extra.get("maxit", 3000)),
                       pc_options=M.PCOptions(ilu_sweeps=0, **kw))
    xj, ij = run(J, jnp.ones(n))
    xt, it = run(T, torch.ones(n, dtype=torch.float64))
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 1, (it.nits, int(ij.nits))
    if it.nits > int(ij.nits):
        xt, _ = run(T, torch.ones(n, dtype=torch.float64), maxit=int(ij.nits))
    elif it.nits < int(ij.nits):
        xj, _ = run(J, jnp.ones(n), maxit=it.nits)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


@pytest.mark.parametrize("pc,kw", [("poly", {}), ("ras", dict(num_blocks=6)),
                                   ("bjacobi", dict(num_blocks=6))])
def test_solve_ir_matches_jax(pc, kw):
    """``solve_ir`` (fp32 inner, 6 sweeps) with the PCs JAX can run there:
    total inner counts JAX's ±max(2, 5 %), x to the fp64 tolerance."""
    Aj, At = SYSTEMS["cd" if pc != "poly" else "lap"]
    n = At.shape[0]
    method = "gmres" if pc != "poly" else "cg"
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, restart=30)
    _, ij = J.solve_ir(Aj, jnp.ones(n), method=method, pc=pc, options=J.SolverOptions(**o),
                       pc_options=J.PCOptions(ilu_sweeps=6, **kw))
    x, it = T.solve_ir(At, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                       options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=6, **kw))
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= max(2, int(0.05 * int(ij.nits)))
    assert np.linalg.norm(1.0 - At.to_scipy() @ x.numpy()) <= 1e-8 * np.sqrt(n) * 1.01


def test_ras_single_block_is_ilu():
    """RAS with one subdomain and no overlap is ILU(k): the same count."""
    At = T.sparse.laplacian_2d(24)
    b = torch.ones(At.shape[0], dtype=torch.float64)
    _, ir = T.solve(At, b, method="gmres", pc="ras",
                    pc_options=T.PCOptions(num_blocks=1, schwarz_overlap=0))
    _, ii = T.solve(At, b, method="gmres", pc="iluk", pc_options=T.PCOptions(ilu_sweeps=0))
    assert ir.nits == ii.nits


def test_ras_uneven_division_and_default_blocks():
    """n not a multiple of the block count (the last window padded), and
    the default count max(2, ⌈n/4096⌉) with overlap 8, against JAX."""
    for N, kw in ((31, dict(num_blocks=7, schwarz_overlap=4)), (96, {})):
        Aj, At = both(J.sparse.laplacian_2d(N).to_scipy())
        n = At.shape[0]
        _, ij = J.solve(Aj, jnp.ones(n), method="gmres", pc="ras", pc_options=J.PCOptions(**kw))
        x, it = T.solve(At, torch.ones(n, dtype=torch.float64), method="gmres", pc="ras",
                        pc_options=T.PCOptions(**kw))
        assert it.converged and abs(it.nits - int(ij.nits)) <= 1
    M = T.pc.setup(At, "ras", device="cpu")
    assert M.name == "ras(B=3,o=8)"


def test_poly_degree_and_transpose():
    """A higher degree takes fewer CG iterations, and p(A) of a symmetric A
    is symmetric: M.t = M."""
    At = T.sparse.laplacian_2d(48)
    b = torch.ones(At.shape[0], dtype=torch.float64)
    nits = [T.solve(At, b, method="cg", pc="poly", pc_options=T.PCOptions(poly_degree=d))[1].nits
            for d in (4, 16)]
    assert nits[1] < nits[0]
    M = T.pc.setup(T.sparse.laplacian_2d(16), "poly", T.PCOptions(poly_degree=6), device="cpu")
    r = torch.from_numpy(np.linspace(1.0, 2.0, 256))
    np.testing.assert_allclose(M.t(r).numpy(), M(r).numpy(), rtol=1e-12)


def test_option_errors():
    A = T.sparse.laplacian_2d(8)
    with pytest.raises(ValueError, match="omega"):
        T.pc.setup(A, "ssor", T.PCOptions(omega=2.0), device="cpu")
    with pytest.raises(ValueError, match="omega"):
        T.pc.setup(A, "sor", T.PCOptions(omega=0.0), device="cpu")
    with pytest.raises(ValueError, match="poly_degree"):
        T.pc.setup(A, "poly", T.PCOptions(poly_degree=0), device="cpu")
