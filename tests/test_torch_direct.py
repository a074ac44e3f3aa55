"""The direct solvers of lssp_tpu_torch against lssp_tpu on the CPU: the
minimum-degree ordering (``sparse/reorder.amd_permutation``), the
Gilbert–Peierls and multifrontal LU (``pc/lu_host.py``,
``pc/multifrontal.py``), the compact level schedule (``ops/trisolve.py``),
the ``lu`` PC, ``direct`` / ``splu`` through every entry point, the sparse
QR (``pc/qr_host.py``) and ``solve_lsq``.

Host factors, orderings and R come out bit for bit as JAX's: both packages
run the same numpy and the same C++ (``native/src/{amd,splu,mf,spqr}.cpp``),
and within one test process the same BLAS behind scipy.  Applies on JAX's
own factors (``interop.splu_from_jax``) to 1e-12 in fp64; solves to JAX's
bounds (``tests/test_direct.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import lssp_tpu as J
from lssp_tpu.pc import lu_host as jlu
from lssp_tpu.pc import multifrontal as jmf
from lssp_tpu.pc import qr_host as jqr
from lssp_tpu.sparse import reorder as jreorder
from lssp_tpu.sparse.utils import transpose as jtranspose
import lssp_tpu_torch as T
from lssp_tpu_torch import interop, native
from lssp_tpu_torch.ops import trisolve as ttri
from lssp_tpu_torch.pc import lu_host as tlu
from lssp_tpu_torch.pc import multifrontal as tmf
from lssp_tpu_torch.pc import qr_host as tqr
from lssp_tpu_torch.pc.ilu_host import iluk_factor, ilut_factor
from lssp_tpu_torch.sparse import reorder as treorder

GENS = {
    "laplacian_2d_16": lambda M: M.sparse.laplacian_2d(16),
    "laplacian_2d_24": lambda M: M.sparse.laplacian_2d(24),
    "laplacian_2d_32": lambda M: M.sparse.laplacian_2d(32),
    "convdiff_12": lambda M: M.sparse.convection_diffusion_2d(12, beta=25.0),
    "convdiff_20": lambda M: M.sparse.convection_diffusion_2d(20, beta=25.0),
    "random_150": lambda M: M.sparse.random_sparse(150, nnz_per_row=6, seed=1),
    "random_500": lambda M: M.sparse.random_sparse(500, nnz_per_row=5, seed=3),
    "shifted_10": lambda M: M.CSR.from_scipy(
        (M.sparse.laplacian_2d(10).to_scipy() - 3.0 * sp.eye(100)).tocsr()),
}


def both(name):
    return GENS[name](J), GENS[name](T)


def same_csr(Fj, Ft):
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(Fj, a)), np.asarray(getattr(Ft, a)))
    assert tuple(Fj.shape) == tuple(Ft.shape)


def same_splu(fj, ft):
    same_csr(fj.L, ft.L)
    same_csr(fj.U, ft.U)
    np.testing.assert_array_equal(fj.perm_in, ft.perm_in)
    np.testing.assert_array_equal(fj.perm_out, ft.perm_out)
    assert fj.nclamped == ft.nclamped


def dense_solve(f, b):
    n = len(b)
    y = np.linalg.solve(f.L.todense() + np.eye(n), b[f.perm_in])
    return np.linalg.solve(f.U.todense(), y)[f.perm_out]


# the factor cells: JAX's own sizes (tests/test_direct.py), every ordering of
# the scalar engine and the multifrontal engine
FACTOR_CELLS = [("laplacian_2d_16", "rcm", "gp"), ("convdiff_12", "rcm", "gp"),
                ("random_150", None, "gp"), ("laplacian_2d_24", "amd", "gp"),
                ("convdiff_20", "amd", "gp"), ("random_500", "amd", "gp"),
                ("shifted_10", "amd", "auto"), ("laplacian_2d_24", "amd", "mf"),
                ("convdiff_20", "amd", "mf"), ("random_500", "amd", "mf"),
                ("laplacian_2d_32", "amd", "auto")]


@pytest.mark.parametrize("name,order,method", FACTOR_CELLS)
def test_splu_factor_bitwise(name, order, method):
    """``splu_factor`` equals JAX's bit for bit (L, U, both permutations, the
    clamp count), and solves A x = b as scipy's ``spsolve`` does."""
    Aj, At = both(name)
    fj = jlu.splu_factor(Aj, order=order, method=method)
    ft = tlu.splu_factor(At, order=order, method=method)
    same_splu(fj, ft)
    assert ft.nclamped == 0
    b = np.linspace(1.0, 2.0, At.shape[0])
    np.testing.assert_allclose(dense_solve(ft, b), spla.spsolve(At.to_scipy().tocsc(), b),
                               rtol=1e-8, atol=1e-10)


def test_auto_ignores_order_and_pivot_tol_at_512():
    """ROADMAP C property 5, matched: ``method="auto"`` takes the multifrontal
    engine for n ≥ 512 with AMD ordering and ignores ``pivot_tol`` there, as
    JAX does (so the two packages factor with the same engine); below 512,
    or with ``method="gp"``, ``pivot_tol`` applies."""
    Aj, At = both("laplacian_2d_32")
    mf = tmf.mf_factor(At)
    same_splu(mf, tlu.splu_factor(At, pivot_tol=1.0))
    same_splu(jlu.splu_factor(Aj, pivot_tol=1.0), tlu.splu_factor(At, pivot_tol=1.0))
    gp = tlu.splu_factor(At, pivot_tol=1.0, method="gp")
    assert gp.L.nnz != mf.L.nnz or not np.array_equal(gp.L.data, mf.L.data)
    same_splu(jlu.splu_factor(Aj, pivot_tol=1.0, method="gp"), gp)


def test_splu_python_oracle_matches_native():
    """``_splu_python`` (the oracle) and the C++ engine give the same factors
    (``tests/test_direct.py: test_python_native_parity``)."""
    A = T.sparse.convection_diffusion_2d(8, beta=15.0)
    f = tlu.splu_factor(A, order=None)
    from lssp_tpu_torch.sparse.utils import transpose
    Bt = transpose(A)
    Lp, Li, Lx, Up, Ui, Ux, pinv, ncl = tlu._splu_python(
        np.asarray(Bt.indptr, np.int64), np.asarray(Bt.indices, np.int64),
        np.asarray(Bt.data, np.float64), A.shape[0], 0.1, 1e-10, 1e-3)
    np.testing.assert_array_equal(f.L.todense(), transpose(T.CSR(Lp, Li, Lx, A.shape)).todense())
    np.testing.assert_array_equal(f.U.todense(), transpose(T.CSR(Up, Ui, Ux, A.shape)).todense())


def test_zero_pivot_clamped():
    A = T.CSR.from_scipy(sp.diags(np.r_[np.ones(9), 0.0]).tocsr())
    assert tlu.splu_factor(A, order=None).nclamped >= 1


@pytest.mark.parametrize("name", ["convdiff_12", "random_150", "random_500", "laplacian_2d_24"])
def test_amd_permutation(name, monkeypatch):
    """``amd_permutation`` equals JAX's; the port's C++ path and its Python
    oracle return the identical permutation."""
    Aj, At = both(name)
    p = treorder.amd_permutation(At)
    np.testing.assert_array_equal(p, jreorder.amd_permutation(Aj))
    np.testing.assert_array_equal(np.sort(p), np.arange(At.shape[0]))
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(treorder.amd_permutation(At), p)
    ip, ix = np.asarray(At.indptr, np.int64), np.asarray(At.indices, np.int64)
    for a, b in zip(treorder._transpose_pattern(ip, ix, At.shape[0]),
                    jreorder._transpose_pattern(ip, ix, At.shape[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["convdiff_20", "random_500"])
def test_multifrontal_symbolic_and_oracle(name, monkeypatch):
    """The elimination tree and the supernode partition equal JAX's; the
    numeric oracle ``mf_factor_arrays`` equals JAX's bit for bit (same scipy
    LAPACK calls) and solves as the C++ engine does."""
    Aj, At = both(name)
    S = At.to_scipy()
    M = ((S != 0) + (S != 0).T).tocsr()
    M.sort_indices()
    np.testing.assert_array_equal(tmf.etree_sym(M.indptr, M.indices, At.shape[0]),
                                  jmf.etree_sym(M.indptr, M.indices, Aj.shape[0]))
    sj, st = jmf.mf_symbolic(Aj), tmf.mf_symbolic(At)
    for a in ("perm", "sn_start", "sn_parent"):
        np.testing.assert_array_equal(getattr(sj, a), getattr(st, a))
    assert sj.nnz_lu == st.nnz_lu and all(np.array_equal(a, b)
                                          for a, b in zip(sj.rowsets, st.rowsets))
    Lj, Uj, rj, cj = jmf.mf_factor_arrays(Aj, sj)
    Lt, Ut, rt, ct = tmf.mf_factor_arrays(At, st)
    same_csr(Lj, Lt)
    same_csr(Uj, Ut)
    np.testing.assert_array_equal(rj, rt)
    monkeypatch.setattr(tmf, "_mf_factor_native", lambda *a, **k: None)
    b = np.linspace(-1.0, 1.0, At.shape[0])
    x_py = dense_solve(tmf.mf_factor(At), b)
    monkeypatch.undo()
    np.testing.assert_allclose(x_py, dense_solve(tmf.mf_factor(At), b), rtol=1e-9, atol=1e-11)


def test_multifrontal_zero_pivot_clamped():
    A = T.sparse.random_sparse(600, nnz_per_row=4, seed=5).to_scipy().tolil()
    A[5, :] = 0.0
    A[:, 5] = 0.0
    A[5, 6] = 1e-30
    A[6, 5] = 1e-30
    assert tmf.mf_factor(T.CSR.from_scipy(A.tocsr())).nclamped >= 1


# -- the level schedule -------------------------------------------------------

def _ratchet_ilu_factors():
    A = T.sparse.laplacian_2d(32)
    cd = T.sparse.convection_diffusion_2d(32, beta=10.0)
    return {"ilu0@32": iluk_factor(A, level=0), "iluk1@32": iluk_factor(A, level=1),
            "ilut@32": ilut_factor(A), "ilut convdiff@32": ilut_factor(cd),
            "iluk2 convdiff@32": iluk_factor(cd, level=2)}


def _layouts(F, lower):
    """Both layouts of one factor, whatever ``level_schedule`` picks."""
    ip, idx, dat, diag, lev = ttri._strict_levels(F, lower, None)
    n = F.shape[0]
    return (ttri._padded(ip, idx, dat, diag, lev, n, "cpu"),
            ttri._compact(ip, idx, dat, diag, lev, n, "cpu"))


@pytest.mark.parametrize("key", sorted(_ratchet_ilu_factors()))
def test_compact_layout_on_ratchet_ilu_factors(key):
    """The ratchet systems' ILU factors under the 2× rule, and the two
    layouts' sweeps against each other: bit for bit wherever every row
    holds at most four entries (the row sums then run in one order on the
    CPU), to 1e-14 on the longer rows of ILUT and ILU(2) (another order),
    for a vector and a block.  ILU(0) of the 2-D Laplacian needs just over
    2× its nnz in JAX's layout, so it runs the compact one, bitwise as
    before."""
    L, U = _ratchet_ilu_factors()[key]
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.standard_normal(L.shape[0]))
    R = torch.from_numpy(rng.standard_normal((L.shape[0], 3)))
    (pl, cl), (pu, cu) = _layouts(L, True), _layouts(U, False)
    short = True
    for F, lower, pad, com in ((L, True, pl, cl), (U, False, pu, cu)):
        ip, idx = ttri._strict_levels(F, lower, None)[:2]
        want = pad if pad.slots <= 2 * len(idx) else com
        s = ttri.level_schedule(F, lower=lower)
        assert type(s) is type(want) and s.slots == want.slots
        short &= int(np.diff(ip).max()) <= 4
    for v in (r, R):
        zp, zc = ttri.ilu_apply(pl, pu, v), ttri.ilu_apply(cl, cu, v)
        if short:
            assert torch.equal(zp, zc)
        else:
            assert float((zc - zp).abs().max() / zp.abs().max()) <= 1e-14


@pytest.mark.parametrize("name", ["laplacian_2d_24", "convdiff_20", "random_500"])
def test_compact_schedule_on_lu_factors(name):
    """On LU factors (long separator rows) the compact layout agrees with the
    padded one to 1e-13 (the row sums run in another order) and with a
    dense solve, forward and transposed, for a vector and a block; an apply
    repeats bitwise."""
    _, At = both(name)
    f = tlu.splu_factor(At)
    n = At.shape[0]
    rng = np.random.default_rng(1)
    r = torch.from_numpy(rng.standard_normal(n))
    R = torch.from_numpy(rng.standard_normal((n, 2)))
    (pl, cl), (pu, cu) = _layouts(f.L, True), _layouts(f.U, False)
    pad, com = (pl, pu), (cl, cu)
    for v in (r, R):
        zc = ttri.ilu_apply(*com, v)
        zp = ttri.ilu_apply(*pad, v)
        assert float((zc - zp).abs().max() / zp.abs().max()) <= 1e-13
        assert torch.equal(zc, ttri.ilu_apply(*com, v))
    dense = np.linalg.solve(f.U.todense(), np.linalg.solve(f.L.todense() + np.eye(n), r.numpy()))
    np.testing.assert_allclose(ttri.ilu_apply(*com, r).numpy(), dense, rtol=1e-10, atol=1e-12)
    ut, lt = (_layouts(T.sparse.utils.transpose(f.U), True)[1],
              _layouts(T.sparse.utils.transpose(f.L), False)[1])
    dense_t = np.linalg.solve((f.L.todense() + np.eye(n)).T, np.linalg.solve(f.U.todense().T,
                                                                              r.numpy()))
    np.testing.assert_allclose(ttri.ilu_apply_t(ut, lt, r).numpy(), dense_t, rtol=1e-10,
                               atol=1e-12)


def test_lu_schedule_of_laplacian_128_is_compact():
    """``laplacian_2d(128)``'s LU (AMD, multifrontal): JAX's padded layout
    would need nlev·w·k = 3.2e9 slots for L and 5.9e7 for U; the port's
    schedule holds at most 2× each factor's nnz."""
    A = T.sparse.laplacian_2d(128)
    f = tlu.splu_factor(A)
    from lssp_tpu_torch.sparse.utils import split_ldu
    for F, lower in ((f.L, True), (f.U, False)):
        s = ttri.level_schedule(F, lower=lower)
        S = split_ldu(F)[0 if lower else 2]
        ip = np.asarray(S.indptr, np.int64)
        lev = native.levels(ip, np.asarray(S.indices, np.int64), A.shape[0], lower)
        padded = (int(lev.max()) + 1) * int(np.bincount(lev).max()) * int(np.diff(ip).max())
        assert isinstance(s, ttri.CompactSchedule)
        assert s.slots <= 2 * F.nnz and padded > (3e9 if lower else 5e7)


# -- the lu PC and the direct solves -------------------------------------------

@pytest.mark.parametrize("name", ["convdiff_20", "random_500", "laplacian_2d_32"])
def test_lu_apply_on_jax_factors(name):
    """The port's ``lu`` apply and M⁻ᵀ on JAX's own factors
    (``splu_from_jax``) against JAX's ``lu`` PC, fp64, 1e-12; a block
    column by column; the port's own setup gives the same state."""
    Aj, At = both(name)
    Mj = J.pc.setup(Aj, "lu", J.PCOptions(transpose=True))
    fj = jlu.splu_factor(Aj)
    arr = lambda F: (np.asarray(F.indptr), np.asarray(F.indices), np.asarray(F.data), F.shape)
    ft = interop.splu_from_jax(arr(fj.L), arr(fj.U), fj.perm_in, fj.perm_out, fj.nclamped)
    from lssp_tpu_torch.pc.lu import _lu_apply, _lu_apply_t, lu_state
    st = lu_state(ft, np.float64, "cpu", transpose=True)
    Mt = T.pc.setup(At, "lu", T.PCOptions(transpose=True), device="cpu")
    rng = np.random.default_rng(0)
    r = rng.standard_normal(At.shape[0])
    R = rng.standard_normal((At.shape[0], 3))
    for ft_, fj_ in ((_lu_apply, Mj), (_lu_apply_t, Mj.t)):
        ref = np.asarray(fj_(jnp.asarray(r)))
        got = ft_(st, torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
        Z = ft_(st, torch.from_numpy(R)).numpy()
        for c in range(3):
            np.testing.assert_allclose(Z[:, c], ft_(st, torch.from_numpy(R[:, c].copy())).numpy(),
                                       rtol=1e-13, atol=1e-13 * np.abs(Z).max())
    np.testing.assert_array_equal(Mt(torch.from_numpy(r)).numpy(),
                                  _lu_apply(st, torch.from_numpy(r)).numpy())
    Mf = T.pc.setup(At, "lu", T.PCOptions(), device="cpu")
    with pytest.raises(ValueError, match="transpose"):
        Mf.t(torch.from_numpy(r))


@pytest.mark.parametrize("method", ["direct", "splu"])
def test_direct_solve(method):
    """``solve(method=...)`` installs ``pc="lu"``: nits 1, the true residual
    reported (< 1e-9), x equal to JAX's to 1e-12."""
    Aj, At = J.sparse.convection_diffusion_2d(20, beta=10.0), \
        T.sparse.convection_diffusion_2d(20, beta=10.0)
    xj, ij = J.solve(Aj, jnp.ones(400), method=method)
    xt, it = T.solve(At, torch.ones(400, dtype=torch.float64), method=method)
    assert it.nits == 1 == int(ij.nits) and it.converged
    res = np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy())
    assert res < 1e-9 and abs(it.residual - res) <= 1e-12
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError, match="exact preconditioner"):
        T.solvers.get_solver(method)(At.to(torch.device("cpu")), torch.ones(400,
                                     dtype=torch.float64), opts=T.SolverOptions().resolved())


def test_lu_pc_one_iteration():
    A = T.sparse.laplacian_2d(24)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    for method in ("cg", "gmres", "bicgstab"):
        x, info = T.solve(A, b, method=method, pc="lu")
        assert info.nits <= 2, method
        assert np.linalg.norm(1.0 - A.to_scipy() @ x.numpy()) < 1e-8


def test_solver_caches_the_factorization(monkeypatch):
    """``Solver(method="direct")``: one factorization for three right-hand
    sides (counted), each solve exact, x(2b) = 2·x(b)."""
    from lssp_tpu_torch.pc import lu as tlu_pc
    calls = []
    orig = tlu_pc.splu_factor
    monkeypatch.setattr(tlu_pc, "splu_factor", lambda *a, **k: calls.append(1) or orig(*a, **k))
    A = T.sparse.convection_diffusion_2d(16, beta=5.0)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    s = T.Solver(method="direct", device="cpu").assemble(A, b)
    x1 = s.solve()
    x2 = s.solve(b=2 * b)
    x3 = s.solve(b=torch.arange(A.shape[0], dtype=torch.float64))
    assert len(calls) == 1 and s.nits == 1 and s.M.name == "lu"
    np.testing.assert_allclose(x2.numpy(), 2 * x1.numpy(), rtol=1e-10)
    r = np.arange(A.shape[0]) - A.to_scipy() @ x3.numpy()
    assert np.linalg.norm(r) < 1e-8 * np.linalg.norm(np.arange(A.shape[0]))


def test_solve_ir_direct():
    """Mixed precision: the fp32 LU inner, fp64 refinement, against JAX's
    rounds (each round one inner iteration)."""
    Aj, At = J.sparse.laplacian_2d(24), T.sparse.laplacian_2d(24)
    o = dict(rtol=1e-10, atol=0.0)
    xj, ij = J.solve_ir(Aj, jnp.ones(576), method="direct", options=J.SolverOptions(**o))
    xt, it = T.solve_ir(At, torch.ones(576, dtype=torch.float64), method="direct",
                        options=T.SolverOptions(**o), device="cpu")
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 1
    assert np.linalg.norm(1 - At.to_scipy() @ xt.numpy()) <= 1e-10 * 24
    _, _, _, _, M32 = T.prepare_ir(At, method="direct", device="cpu")
    assert M32.name == "lu" and M32.state[0].vals.dtype == torch.float32


def test_solve_multi_direct():
    """The per-column form: M applied once to the (n, k) residual block;
    every column equals its single solve to 1e-12, nits 1 each."""
    A = T.sparse.convection_diffusion_2d(16, beta=5.0)
    B = torch.from_numpy(np.random.default_rng(2).standard_normal((256, 4)))
    X, info = T.solve_multi(A, B, method="direct")
    assert info.nits.tolist() == [1, 1, 1, 1] and info.converged.all()
    for c in range(4):
        x, _ = T.solve(A, B[:, c], method="direct")
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=1e-12, atol=1e-14)


# -- sparse QR and solve_lsq ----------------------------------------------------

def _ill_conditioned(M, m=200, n=100, cond_exp=8, seed=1):
    A0 = sp.random(m, n, density=0.04, random_state=seed, format="csr")
    A0 = A0 + sp.vstack([sp.eye(n), sp.csr_matrix((m - n, n))]).tocsr()
    return M.CSR.from_scipy((A0 @ sp.diags(np.logspace(0, -cond_exp, n))).tocsr())


def _tall(M, N=64):
    """[L; 0.1·I], L = laplacian_2d(N): m·n > 2e7 at N = 64, the sparse QR route."""
    L = M.sparse.laplacian_2d(N).to_scipy()
    S = sp.vstack([L, 0.1 * sp.eye(L.shape[0], format="csr")]).tocsr()
    S.sort_indices()
    return M.CSR.from_scipy(S)


@pytest.mark.parametrize("native_path", [True, False])
def test_qr_factor_bitwise(native_path, monkeypatch):
    """``qr_factor`` equals JAX's (R row by row, the column order, Qᵀb, the
    residual norm) on the C++ merge loop; the Python oracle agrees with it
    to 1e-12 (``tests/test_native.py: test_native_spqr_matches_python_oracle``)."""
    A0 = sp.random(150, 70, density=0.04, random_state=2, format="csr")
    A0 = (A0 + sp.vstack([sp.eye(70), sp.csr_matrix((80, 70))])).tocsr()
    b = np.arange(150, dtype=float)
    fj = jqr.qr_factor(J.CSR.from_scipy(A0), b=b)
    if not native_path:
        monkeypatch.setattr(native, "available", lambda: False)
    ft = tqr.qr_factor(T.CSR.from_scipy(A0), b=b)
    np.testing.assert_array_equal(fj.cperm, ft.cperm)
    if native_path:
        for (cj, vj), (ct, vt) in zip(fj.Rrows, ft.Rrows):
            np.testing.assert_array_equal(cj, ct)
            np.testing.assert_array_equal(vj, vt)
        np.testing.assert_array_equal(fj.c, ft.c)
        assert fj.resnorm == ft.resnorm
    np.testing.assert_allclose(tqr.qr_solve(ft), jqr.qr_solve(fj), rtol=1e-12, atol=1e-13)
    assert abs(ft.resnorm - np.linalg.norm(b - A0 @ tqr.qr_solve(ft))) <= 1e-10 * ft.resnorm


def test_lsq_overdetermined_matches_lstsq(rng):
    m, n = 300, 120
    As = sp.random(m, n, density=0.08, random_state=5, format="csr")
    As = (As + sp.vstack([sp.eye(n), sp.csr_matrix((m - n, n))])).tocsr()
    b = rng.standard_normal(m)
    x, res = T.solve_lsq(T.CSR.from_scipy(As), b, device="cpu")
    xs, *_ = np.linalg.lstsq(As.toarray(), b, rcond=None)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), xs, rtol=1e-8, atol=1e-10)
    assert res < 1e-10


def test_lsq_square_reproduces_direct():
    A = T.sparse.laplacian_2d(16)
    b = np.linspace(1.0, 2.0, 256)
    for method in ("qr", "normal"):
        x, _ = T.solve_lsq(A, b, method=method, device="cpu")
        assert np.linalg.norm(b - A.to_scipy() @ x.numpy()) < 1e-9


def test_lsq_qr_beats_normal_equations_at_cond_1e8():
    x_true = np.random.default_rng(0).standard_normal(100)
    Aj, At = _ill_conditioned(J), _ill_conditioned(T)
    b = At.to_scipy() @ x_true
    x_qr, _ = T.solve_lsq(At, b, method="qr", device="cpu")
    err_qr = np.linalg.norm(x_qr.numpy() - x_true) / np.linalg.norm(x_true)
    assert err_qr < 1e-7
    x_ne, _ = T.solve_lsq(At, b, method="normal", device="cpu")
    err_ne = np.linalg.norm(x_ne.numpy() - x_true) / np.linalg.norm(x_true)
    assert err_ne > 1e3 * err_qr
    np.testing.assert_allclose(x_qr.numpy(), np.asarray(J.solve_lsq(Aj, b, method="qr")[0]),
                               rtol=1e-12, atol=1e-14)


def test_lsq_matches_dense_lstsq_oracle():
    b = np.random.default_rng(3).standard_normal(150)
    A = _ill_conditioned(T, 150, 80, cond_exp=4, seed=5)
    x, res = T.solve_lsq(A, b, method="qr", device="cpu")
    xd, *_ = np.linalg.lstsq(A.to_scipy().toarray(), b, rcond=None)
    np.testing.assert_allclose(x.numpy(), xd, rtol=1e-8, atol=1e-10)
    assert res < 1e-8


@pytest.mark.parametrize("method", ["qr", "normal"])
def test_lsq_sparse_route_matches_jax(method):
    """The tall [L; 0.1·I] at L = laplacian_2d(64) (8,192 × 4,096: m·n > 2e7,
    the sparse QR route): x equal to JAX's (qr: to 1e-13; normal: the same
    AMD LU of AᵀA, to 1e-10), ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ ≤ 1e-10, x to 1e-8 of
    ``spsolve(AᵀA, Aᵀb)``."""
    Aj, At = _tall(J), _tall(T)
    S = At.to_scipy()
    b = S @ np.ones(S.shape[1]) + 0.01 * np.random.default_rng(4).standard_normal(S.shape[0])
    xt, res = T.solve_lsq(At, torch.from_numpy(b), method=method)
    xj, resj = J.solve_lsq(Aj, b, method=method)
    assert xt.device.type == "cpu"
    tol = 1e-13 if method == "qr" else 1e-10
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=tol, atol=tol)
    atb = S.T @ b
    assert res / np.linalg.norm(atb) <= 1e-10
    xs = spla.spsolve((S.T @ S).tocsc(), atb)
    assert np.linalg.norm(xt.numpy() - xs) <= 1e-8 * np.linalg.norm(xs)


def test_qr_resolve_new_rhs_csne():
    rng = np.random.default_rng(7)
    A = _ill_conditioned(T, 150, 80, cond_exp=6, seed=9)
    f = tqr.qr_factor(A, b=A.to_scipy() @ rng.standard_normal(80))
    x2_true = rng.standard_normal(80)
    x2 = tqr.qr_solve(f, b=A.to_scipy() @ x2_true)
    assert np.linalg.norm(x2 - x2_true) / np.linalg.norm(x2_true) < 1e-7


def test_lsq_underdetermined_minnorm_dense():
    A0 = sp.random(40, 80, density=0.1, random_state=3, format="csr")
    A0 = (A0 + sp.hstack([sp.eye(40), sp.csr_matrix((40, 40))])).tocsr()
    b = np.random.default_rng(5).standard_normal(40)
    x, _ = T.solve_lsq(T.CSR.from_scipy(A0), b, method="qr", device="cpu")
    np.testing.assert_allclose(A0 @ x.numpy(), b, atol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.linalg.pinv(A0.toarray()) @ b, atol=1e-8)


def test_lsq_underdetermined_minnorm_sparse():
    """The Q-less route (``qr_solve_minnorm`` on a factorization of Aᵀ)
    directly, and through ``solve_lsq`` past m·n = 2e7 (wide [L, 0.1·I]ᵀ-like
    system: the transpose of the tall one), against JAX's."""
    A0 = sp.random(60, 120, density=0.08, random_state=4, format="csr")
    A0 = (A0 + sp.hstack([sp.eye(60), sp.csr_matrix((60, 60))])).tocsr()
    b = np.random.default_rng(6).standard_normal(60)
    from lssp_tpu_torch.sparse.utils import transpose
    x = tqr.qr_solve_minnorm(tqr.qr_factor(transpose(T.CSR.from_scipy(A0))), b)
    np.testing.assert_allclose(A0 @ x, b, atol=1e-9)
    np.testing.assert_allclose(x, np.linalg.pinv(A0.toarray()) @ b, atol=1e-8)
    W = _tall(T).to_scipy().T.tocsr()
    W.sort_indices()
    bw = np.random.default_rng(8).standard_normal(W.shape[0])
    xt, _ = T.solve_lsq(T.CSR.from_scipy(W), bw, device="cpu")
    xj, _ = J.solve_lsq(J.CSR.from_scipy(W), bw)
    np.testing.assert_allclose(W @ xt.numpy(), bw, atol=1e-9)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-13)


def test_qr_zero_matrix_and_explicit_zeros():
    f = tqr.qr_factor(T.CSR.from_scipy(sp.csr_matrix((5, 3))), b=np.ones(5))
    x = tqr.qr_solve(f)
    assert np.all(np.isfinite(x)) and np.allclose(x, 0.0)
    np.testing.assert_allclose(f.resnorm, np.sqrt(5.0))
    A0 = sp.csr_matrix((np.array([0.0, 0.0, 1.0, 2.0, 1.0]),
                        (np.array([0, 1, 2, 3, 3]), np.array([0, 0, 1, 1, 2]))), shape=(4, 3))
    assert np.all(np.isfinite(tqr.qr_solve(tqr.qr_factor(T.CSR.from_scipy(A0), b=np.ones(4)))))


def test_lsq_default_device_is_the_card(monkeypatch):
    """``solve_lsq`` follows ``config.resolve_device``: a numpy b with no
    device asks for the card, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        T.solve_lsq(T.sparse.laplacian_2d(4), np.ones(16))
