"""The public-API tail of lssp_tpu_torch (``ops.blas1``, the trisolve
names, ``ops.csr_row_ids``, ``sparse.csr_to_coo`` / ``block_diag_extract``
and the container accessors, ``solvers.operator`` / ``stopping_tol``,
``solvers.base.vdot`` / ``basis_combine`` / ``history_print_host*``,
``pc.ilu.CSRcast``, ``native.dia_convert``, ``solvers.refine.
ir_device_time``, ``Solver.set_log`` / ``reset_type``), each against its
lssp_tpu counterpart on the same inputs."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu import native as jnative
from lssp_tpu import ops as jops
from lssp_tpu.pc.ilu import CSRcast as j_cast
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
from lssp_tpu.solvers import base as jbase
from lssp_tpu.utils.log import set_log as j_set_log
import lssp_tpu_torch as T
from lssp_tpu_torch import native, ops
from lssp_tpu_torch.pc.ilu import CSRcast
from lssp_tpu_torch.pc.ilu_host import iluk_factor
from lssp_tpu_torch.solvers import base
from lssp_tpu_torch.solvers.refine import ir_device_time
from lssp_tpu_torch.utils import set_log


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def test_blas1_matches_jax():
    x, y = _vec(300, 0), _vec(300, 1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(ops.dot(xt, yt).item(), float(jops.dot(xj, yj)), rtol=1e-13)
    np.testing.assert_allclose(ops.norm2(xt).item(), float(jops.norm2(xj)), rtol=1e-13)
    assert ops.dot(xt, yt).item() == base.dot(xt, yt).item()      # the one reduction order
    for name, args in (("axpy", (0.5, x, y)), ("axpby", (0.5, x, -2.0, y)),
                       ("axpbyz", (0.5, x, -2.0, y))):
        tv = getattr(ops, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                  for a in args])
        jv = getattr(jops, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                   for a in args])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_csr_row_ids_matches_jax():
    A = T.sparse.convection_diffusion_2d(7)
    Aj = J.sparse.convection_diffusion_2d(7)
    r = ops.csr_row_ids(A)
    assert r.dtype == np.int32 and np.array_equal(r, jops.csr_row_ids(Aj))


@pytest.mark.parametrize("level", [0, 1])
def test_trisolve_names_match_jax(level):
    """trisolve_lower_unit / trisolve_upper / ilu_apply / make_ilu_apply on
    the same factors, against JAX's exact sweeps, to 1e-13."""
    Aj, At = J.sparse.convection_diffusion_2d(12), T.sparse.convection_diffusion_2d(12)
    Lj, Uj = j_iluk(Aj, level=level)
    Lt, Ut = iluk_factor(At, level=level)
    r = _vec(At.shape[0], 2)
    slj, suj = jops.level_schedule(Lj, lower=True), jops.level_schedule(Uj, lower=False)
    slt, sut = ops.level_schedule(Lt, lower=True), ops.level_schedule(Ut, lower=False)
    rt, rj = torch.from_numpy(r), jnp.asarray(r)
    yt = ops.trisolve_lower_unit(slt, rt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(jops.trisolve_lower_unit(slj, rj)),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(ops.trisolve_upper(sut, yt).numpy(),
                               np.asarray(jops.trisolve_upper(suj, jnp.asarray(yt.numpy()))),
                               rtol=1e-13, atol=1e-13)
    zj = np.asarray(jops.ilu_apply(slj, suj, rj))
    np.testing.assert_allclose(ops.ilu_apply(slt, sut, rt).numpy(), zj, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(ops.make_ilu_apply(Lt, Ut)(rt).numpy(),
                               np.asarray(jops.make_ilu_apply(Lj, Uj)(rj)),
                               rtol=1e-13, atol=1e-13)
    assert isinstance(slt, (ops.TriSchedule, ops.trisolve.CompactSchedule))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_coo_roundtrip(seed):
    """JAX's tests/test_sparse.py:28 case, and the COO accessors."""
    S = sp.random(40, 30, density=0.1, random_state=seed, format="csr")
    A = T.sparse.CSR.from_scipy(S)
    C = T.sparse.csr_to_coo(A)
    Cj = J.sparse.csr_to_coo(J.sparse.CSR.from_scipy(S))
    for f in ("row", "col", "data"):
        assert np.array_equal(getattr(C, f), np.asarray(getattr(Cj, f)))
    assert C.nnz == Cj.nnz and C.dtype == Cj.dtype and C.shape == Cj.shape
    np.testing.assert_array_equal(C.todense(), Cj.todense())
    assert (C.to_scipy() != Cj.to_scipy()).nnz == 0
    B = T.sparse.coo_to_csr(C)
    assert np.allclose(B.todense(), S.toarray())
    C.data[0] = 99.0                                    # a copy, not a view
    assert A.data[0] != 99.0


def test_block_diag_extract_matches_jax():
    """JAX's tests/test_sparse.py:91 case, plus rows whose diagonal block
    is empty (identity rows) and a bad block count."""
    A, Aj = T.sparse.laplacian_2d(4), J.sparse.laplacian_2d(4)
    B, Bj = T.sparse.block_diag_extract(A, 4), J.sparse.block_diag_extract(Aj, 4)
    d, full = B.todense(), A.todense()
    mask = np.zeros((16, 16), bool)
    for blk in range(4):
        sl = slice(blk * 4, (blk + 1) * 4)
        mask[sl, sl] = True
        assert np.allclose(d[sl, sl], full[sl, sl])
    assert np.all(d[~mask] == 0)
    S = sp.csr_matrix(np.kron(np.eye(2), np.ones((3, 3)))[:, ::-1])     # anti-block
    for F in (B, T.sparse.block_diag_extract(T.sparse.CSR.from_scipy(S), 2)):
        Fj = (Bj if F is B else J.sparse.block_diag_extract(J.sparse.CSR.from_scipy(S), 2))
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(F, f), np.asarray(getattr(Fj, f)))
    with pytest.raises(ValueError, match="divisible"):
        T.sparse.block_diag_extract(A, 3)


def test_container_accessors_match_jax():
    A, Aj = T.sparse.convection_diffusion_2d(6), J.sparse.convection_diffusion_2d(6)
    assert (A.nrows, A.ncols) == (Aj.nrows, Aj.ncols)
    assert np.array_equal(A.row_nnz(), Aj.row_nnz())
    E, Ej = T.sparse.csr_to_ell(A), J.sparse.csr_to_ell(Aj)
    assert E.k == Ej.k


def test_solvers_exports_and_base_aliases():
    assert "operator" in T.solvers.__all__ and "stopping_tol" in T.solvers.__all__
    o = J.SolverOptions(rtol=1e-3, atol=1e-9, rbtol=1e-4).resolved()
    assert T.solvers.stopping_tol(2.0, 5.0, o) == jbase.stopping_tol(2.0, 5.0, o)
    A = T.sparse.laplacian_2d(5)
    D = T.sparse.csr_to_dia(A)
    x = torch.from_numpy(_vec(25, 3))
    assert torch.equal(T.solvers.operator(D)(x), ops.spmv(D, x))
    assert base.vdot is base.dot
    V = np.stack([_vec(25, s) for s in range(4)])
    ym = _vec(4, 9)
    got = base.basis_combine(torch.from_numpy(ym), torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbase.basis_combine(jnp.asarray(ym),
                                                                   jnp.asarray(V))),
                               rtol=1e-13, atol=1e-13)


def test_history_print_host_matches_jax(capsys):
    """history_print_host / _multi of a recorded trace print JAX's lines."""
    h = np.array([4.0, 2.0, np.nan, 0.5, np.nan])
    info_t = base.SolveInfo(nits=3, residual=0.5, converged=True, r0norm=4.0, bnorm=8.0,
                            history=h)
    info_j = jbase.SolveInfo(nits=jnp.int32(3), residual=jnp.float64(0.5),
                             converged=jnp.bool_(True), r0norm=jnp.float64(4.0),
                             bnorm=jnp.float64(8.0), history=jnp.asarray(h))
    jbase.history_print_host(info_j)
    jout = capsys.readouterr().out
    base.history_print_host(info_t)
    assert capsys.readouterr().out == jout and jout.count("itr:") == 2
    multi_t = base.SolveInfo(nits=np.array([3, 1]), residual=np.array([0.5, 1.0]),
                             converged=np.array([True, True]), r0norm=np.array([4.0, 2.0]),
                             bnorm=np.array([8.0, 8.0]), history=np.stack([h, h]))
    multi_j = jbase.SolveInfo(*(jnp.asarray(np.asarray(getattr(multi_t, f)))
                                for f in ("nits", "residual", "converged", "r0norm",
                                          "bnorm", "history")))
    jbase.history_print_host_multi(multi_j, 2)
    jout = capsys.readouterr().out
    base.history_print_host_multi(multi_t, 2)
    assert capsys.readouterr().out == jout and "rhs 1:" in jout


def test_csrcast_matches_jax():
    A, Aj = T.sparse.laplacian_2d(4), J.sparse.laplacian_2d(4)
    assert CSRcast(A, np.float64) is A and j_cast(Aj, np.float64) is Aj
    C, Cj = CSRcast(A, np.float32), j_cast(Aj, np.float32)
    assert C.data.dtype == np.float32 and np.array_equal(C.data, np.asarray(Cj.data))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_convert_matches_jax_and_its_oracle(dtype):
    A, Aj = T.sparse.convection_diffusion_2d(20), J.sparse.convection_diffusion_2d(20)
    n = A.shape[0]
    offs, dat = native.dia_convert(A.indptr, A.indices, A.data, n, 64, dtype)
    D = T.sparse.csr_to_dia(A, dtype=dtype)
    assert tuple(offs.tolist()) == D.offsets and dat.dtype == dtype
    assert np.array_equal(dat, D.data.numpy())
    if jnative.available():
        jo, jd = jnative.dia_convert(Aj.indptr, Aj.indices, Aj.data, n, 64, dtype)
        assert np.array_equal(jo, offs) and np.array_equal(jd, dat)
    assert native.dia_convert(A.indptr, A.indices, A.data, n, 3, dtype) is None


def test_ir_device_time_on_the_cpu():
    """JAX's repeat-marginal: (seconds per solve, nits, residual) of the
    solve_ir-equivalent solve; the counts equal solve_ir's."""
    A = T.sparse.laplacian_3d(12)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="cg", pc="ilu0", options=T.SolverOptions(rtol=1e-8, atol=0, rbtol=0))
    dt, nits, res = ir_device_time(A, b, repeats=(1, 2), reps=2, **kw)
    _, info = T.solve_ir(A, b, **kw)
    assert dt >= 0.0 and nits == info.nits and res == info.residual


def test_solver_set_log_and_reset_type(capsys):
    """JAX's test_solver_set_log, and reset_type: to a transpose method the
    PC is rebuilt with its M⁻ᵀ (an exact ILU gets its transposed
    schedules), as JAX's; bicg then solves."""
    buf = io.StringIO()
    A = T.sparse.convection_diffusion_2d(8)
    b = torch.ones(64, dtype=torch.float64)
    s = T.Solver(method="gmres", pc="ilu0", options=T.SolverOptions(verbosity=2), device="cpu")
    s.set_log(buf)
    try:
        s.assemble(A, b)
    finally:
        set_log(None)
    assert "assemble" in buf.getvalue()
    M0 = s.M
    with pytest.raises(ValueError, match="transpose"):
        M0.t(b)
    s.reset_type("bicg")
    assert s.method == "bicg" and s.M is not M0 and len(s.M.state) == 4
    s.options = T.SolverOptions()
    x = s.solve()
    assert s.info.converged
    sj = J.Solver(method="gmres", pc="ilu0")
    sj.assemble(J.sparse.convection_diffusion_2d(8), jnp.ones(64))
    sj.reset_type("bicg")
    xj = sj.solve()
    assert abs(s.nits - int(sj.info.nits)) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6)
    j_set_log(None)
    M1 = s.M
    s.reset_type("qmr")                                # JAX rebuilds again: pc_options unchanged
    assert s.M is not M1 and len(s.M.state) == 4
    s.reset_type("cg")
    assert s.M is not M1 and s.method == "cg"
    capsys.readouterr()
