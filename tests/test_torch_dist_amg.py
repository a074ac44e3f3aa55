"""The distributed AMG of lssp_tpu_torch (``parallel/dist_sa.py``,
``dist_rs.py``, ``dist_amg.py``, the Spike solves of ``ops/tridiag.py``)
against lssp_tpu on the CPU: JAX's ``mesh8`` cases of
``tests/test_dist.py`` and ``tests/test_dist_rs.py`` on the port's 8-slot
CPU mesh.

Tolerances (``tests/test_torch_dist.py``'s): counts JAX's ±2 and x to 1e-8
relative; the refinement paths (fp32 inner) counts ±2 and the true
residual at the stopping rule; the host hierarchies (level partitions,
P̂) bitwise, on the native path JAX took, the Spike solves to 1e-10 of scipy; JAX's own assertions
(convergence, residual bounds, count caps) are kept on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu import native as jnative
from lssp_tpu.parallel import dist_rs as jrs
from lssp_tpu.parallel import dist_sa as jsa
from lssp_tpu.parallel import dist_solve as jsolve
import lssp_tpu_torch as T
from lssp_tpu_torch import native as tnative
from lssp_tpu_torch.ops import tridiag as ttri
from lssp_tpu_torch.parallel import dist_rs as trs
from lssp_tpu_torch.parallel import dist_sa as tsa


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


TMESH = T.make_mesh(8, devices=[torch.device("cpu")] * 8)


@pytest.fixture(autouse=True)
def same_path(monkeypatch):
    """The port's native/oracle choice pinned to the JAX package's: a cold
    JAX native build can fail in one xdist worker (ROADMAP C property 1)."""
    monkeypatch.setattr(tnative, "available", lambda: jnative.available())


def _both(gen, method, pc, mesh8, opts=None, pco=None, multi=False, ir=False, B=None):
    """The same distributed solve in both packages: (x_jax, info_jax,
    x_port, info_port, the port's A)."""
    Aj, At = gen(J), gen(T)
    n = Aj.shape[0]
    B = np.ones(n) if B is None else B
    name = "dist_solve" + ("_ir" if ir else "") + ("_multi" if multi else "")
    xj, ij = getattr(jsolve, name)(Aj, jnp.asarray(B), method=method, pc=pc, mesh=mesh8,
                                   options=J.SolverOptions(**(opts or {})),
                                   pc_options=J.PCOptions(**(pco or {})))
    xt, it = getattr(T, name)(At, torch.from_numpy(B), method=method, pc=pc, mesh=TMESH,
                              options=T.SolverOptions(**(opts or {})),
                              pc_options=T.PCOptions(**(pco or {})))
    return np.asarray(xj), ij, xt.numpy(), it, At


def _close(xj, ij, xt, it):
    assert np.all(np.abs(np.asarray(it.nits) - np.asarray(ij.nits)) <= 2), (it.nits, ij.nits)
    assert np.asarray(it.converged).all() and np.asarray(ij.converged).all()
    assert np.linalg.norm(xt - xj) <= 1e-8 * np.linalg.norm(xj)


def test_gmres_dist_amg(mesh8):
    xj, ij, xt, it, A = _both(lambda M: M.sparse.anisotropic_poisson_2d(64, 0.001), "gmres",
                              "amg", mesh8, opts=dict(restart=30))
    _close(xj, ij, xt, it)
    assert it.nits <= 20
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) <= 1.1e-7 * 64


def test_dist_amg_matches_single_device_iterations(mesh8):
    xj, ij, xt, it, A = _both(lambda M: M.sparse.laplacian_2d(32), "cg", "amg", mesh8)
    _close(xj, ij, xt, it)
    _, i1 = T.solve(A, torch.ones(1024, dtype=torch.float64), method="cg", pc="amg")
    assert abs(it.nits - i1.nits) <= 3


@pytest.mark.parametrize("N", [32, 30], ids=["grid", "padded"])
def test_saamg_matches_jax_and_single_device(N, mesh8):
    """laplacian_2d(32): a shard-aligned grid; (30): 900 rows, the flat plan
    pads the system to the P·gᴸ multiple."""
    xj, ij, xt, it, A = _both(lambda M: M.sparse.laplacian_2d(N), "cg", "saamg", mesh8,
                              opts=dict(maxit=100))
    _close(xj, ij, xt, it)
    assert xt.shape == (N * N,)
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) < 1e-4
    _, i1 = T.solve(A, torch.ones(N * N, dtype=torch.float64), method="cg", pc="saamg",
                    options=T.SolverOptions(maxit=100))
    assert abs(it.nits - i1.nits) <= 4


def test_general_n_and_amg_multi(mesh8):
    n = 225                                  # 225 % 8 != 0: identity padding
    B = np.stack([np.ones(n), np.arange(float(n))], axis=1)
    xj, ij, xt, it, A = _both(lambda M: M.sparse.laplacian_2d(15), "cg", "amg", mesh8,
                              multi=True, B=B)
    _close(xj, ij, xt, it)
    S = A.to_scipy()
    for k in range(2):
        assert np.linalg.norm(B[:, k] - S @ xt[:, k]) <= 1e-4 * max(1.0, np.linalg.norm(B[:, k]))


def test_saamg_multi(mesh8):
    n = 1024
    B = np.stack([np.ones(n), np.arange(float(n)) % 5 + 1], axis=1)
    xj, ij, xt, it, A = _both(lambda M: M.sparse.laplacian_2d(32), "cg", "saamg", mesh8,
                              opts=dict(maxit=100), multi=True, B=B)
    _close(xj, ij, xt, it)
    _, i1 = T.dist_solve(A, torch.from_numpy(B[:, 0].copy()), method="cg", pc="saamg",
                         mesh=TMESH, options=T.SolverOptions(maxit=100))
    assert abs(int(it.nits[0]) - i1.nits) <= 1


def test_ir_multi_blockcg_saamg(mesh8):
    B = np.random.default_rng(42).standard_normal((1024, 3))
    xj, ij, xt, it, A = _both(lambda M: M.sparse.laplacian_2d(32), "blockcg", "saamg", mesh8,
                              opts=dict(rtol=1e-8, atol=0.0, maxit=2000), multi=True, ir=True,
                              B=B)
    assert np.asarray(it.converged).all()
    assert np.all(np.abs(np.asarray(it.nits) - np.asarray(ij.nits)) <= 2), (it.nits, ij.nits)
    res = np.linalg.norm(B - A.to_scipy() @ xt, axis=0)
    assert np.all(res <= 1.1e-8 * np.linalg.norm(B, axis=0) + 1e-10)
    assert int(np.max(it.nits)) <= 20


RS_CASES = [("poisson3d_16", lambda M: M.sparse.laplacian_3d(16), "cg"),
            ("aniso_128", lambda M: M.sparse.anisotropic_poisson_2d(128, epsilon=0.01), "cg"),
            ("convdiff_64", lambda M: M.sparse.convection_diffusion_2d(64), "gmres")]
RS_OPTS = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=100)


@pytest.mark.parametrize("name,gen,method", RS_CASES, ids=[c[0] for c in RS_CASES])
def test_rsamg_matches_jax_and_single_device(name, gen, method, mesh8):
    xj, ij, xt, it, A = _both(gen, method, "rsamg", mesh8, opts=RS_OPTS)
    _close(xj, ij, xt, it)
    n = A.shape[0]
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) < 1e-5 * np.sqrt(n)
    _, i1 = T.solve(A, torch.ones(n, dtype=torch.float64), method=method, pc="rsamg",
                    options=T.SolverOptions(**RS_OPTS))
    assert abs(i1.nits - it.nits) <= 2


def _non_lattice(M, seed_r=4, n=1024):
    R = sp.random(n, n, density=0.008, random_state=seed_r)
    W = -(abs(R) + abs(R.T))
    W = W - sp.diags(W.diagonal())
    return M.sparse.CSR.from_scipy((W + sp.diags(-np.asarray(W.sum(axis=1)).ravel() + 0.05))
                                   .tocsr())


def test_rsamg_non_lattice_falls_back(mesh8):
    with pytest.warns(RuntimeWarning, match="shard-alignable lattice"):
        xj, ij, xt, it, A = _both(_non_lattice, "cg", "rsamg", mesh8, opts=RS_OPTS)
    _close(xj, ij, xt, it)
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) < 1e-5 * np.sqrt(1024)


def test_dist_ir_rsamg(mesh8):
    xj, ij, xt, it, A = _both(lambda M: M.sparse.anisotropic_poisson_2d(64, epsilon=0.01),
                              "cg", "rsamg", mesh8, ir=True)
    assert it.converged and abs(it.nits - int(ij.nits)) <= 2
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) / 64.0 < 1e-6


def test_saamg_line_smoother(mesh8):
    xj, ij, xt, it, A = _both(lambda M: M.sparse.anisotropic_poisson_2d(32, epsilon=0.01),
                              "cg", "saamg", mesh8, opts=dict(maxit=300),
                              pco=dict(amg_smoother="line"))
    _close(xj, ij, xt, it)
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) <= 2e-6


def test_line_smoother_crossing_lines(mesh8):
    """A 1-D chain has a ±1 coupling at every shard cut: the Spike solve
    keeps whole-line smoothing, at the single-device count ±4."""
    S = sp.diags([-np.ones(511), 2.0 * np.ones(512), -np.ones(511)], [-1, 0, 1], format="csr")
    xj, ij, xt, it, A = _both(lambda M: M.sparse.CSR.from_scipy(S), "cg", "saamg", mesh8,
                              opts=dict(maxit=1000), pco=dict(amg_smoother="line"))
    _close(xj, ij, xt, it)
    assert np.linalg.norm(1.0 - S @ xt) <= 5e-5
    _, i1 = T.solve(A, torch.ones(512, dtype=torch.float64), method="cg",
                    M=T.pc.setup(A, "saamg", T.PCOptions(amg_smoother="line"), device="cpu"),
                    options=T.SolverOptions(maxit=1000), reorder=None)
    assert abs(it.nits - i1.nits) <= 4


def test_line_smoother_misaligned_grid(mesh8):
    """gy % P != 0 (flat mode) and R % gx != 0 (lines cut mid-row)."""
    gen = lambda M: M.sparse.anisotropic_poisson_2d(36, epsilon=0.01)   # noqa: E731
    xj, ij, xt, it, A = _both(gen, "cg", "saamg", mesh8, opts=dict(maxit=300),
                              pco=dict(amg_smoother="line", saamg_grid=False))
    _close(xj, ij, xt, it)
    assert np.linalg.norm(1.0 - A.to_scipy() @ xt) <= 2e-6
    _, ic = T.dist_solve(A, torch.ones(A.shape[0], dtype=torch.float64), method="cg",
                         pc="saamg", mesh=TMESH, options=T.SolverOptions(maxit=300),
                         pc_options=T.PCOptions(saamg_grid=False))
    assert it.nits <= ic.nits


def test_grid_stall_falls_back_to_flat(mesh8):
    """x exhausted and (gy/P) % g != 0 stops grid coarsening far above
    coarse_size: the flat planned-padding hierarchy is built instead, and
    the launcher grows the system to its size."""
    gy, gx, eps = 48, 64, 1e-3
    Ty = sp.diags([-np.ones(gy - 1), 2 * np.ones(gy), -np.ones(gy - 1)], [-1, 0, 1])
    Tx = sp.diags([-np.ones(gx - 1), 2 * np.ones(gx), -np.ones(gx - 1)], [-1, 0, 1])
    S = (sp.kron(Ty, sp.eye(gx)) * eps + sp.kron(sp.eye(gy), Tx)).tocsr()
    At = T.sparse.CSR.from_scipy(S)
    with pytest.warns(RuntimeWarning, match="falling back to the flat hierarchy"):
        h = tsa.build_dist_sa(At, 8, coarse_size=8, grid=(gy, gx))
    assert h.coarse_inv.shape[1] <= 32 and h.n_top > gy * gx
    pco = dict(saamg_grid=(gy, gx), amg_coarse_size=8)
    with pytest.warns(RuntimeWarning, match="falling back"):
        xj, ij, xt, it, _ = _both(lambda M: M.sparse.CSR.from_scipy(S), "cg", "saamg", mesh8,
                                  opts=dict(maxit=400), pco=pco)
    _close(xj, ij, xt, it)


@pytest.mark.parametrize("gen,kw", [
    (lambda M: M.sparse.laplacian_2d(32), {}),
    (lambda M: M.sparse.laplacian_2d(30), {}),
    (lambda M: M.sparse.anisotropic_poisson_2d(32, epsilon=0.01), dict(smoother="line"))],
    ids=["grid", "flat", "line"])
def test_dist_sa_hierarchy_bitwise(gen, kw):
    """The partitioned levels, shard-local descriptors, line parts and the
    coarse inverse are JAX's arrays (fp64); 30² has no shard-aligned grid,
    so the flat plan pads it."""
    A, Aj = gen(T), gen(J)
    hj = jsa.build_dist_sa(Aj, 8, **kw)
    ht = tsa.build_dist_sa(A, 8, **kw)
    assert len(ht.levels) == len(hj.levels) and ht.n_top == hj.n_top
    for lt_, lj in zip(ht.levels, hj.levels):
        assert (lt_.n_next, lt_.agg, lt_.lmax) == (lj.n_next, lj.agg, lj.lmax)
        assert np.array_equal(lt_.dinv.numpy(), np.asarray(lj.dinv))
        for Mt, Mj in ((lt_.A, lj.A), (lt_.B, lj.B), (lt_.C, lj.C)):
            assert (Mt is None) == (Mj is None)
            if Mt is not None and hasattr(Mj, "offsets"):
                assert Mt.offsets == tuple(Mj.offsets)
                assert np.array_equal(Mt.data.numpy(), np.asarray(Mj.data))
        if lj.tri is not None:
            for a, b in zip(lt_.tri[:5], lj.tri[:5]):
                assert np.array_equal(a.numpy(), np.asarray(b))
            assert np.array_equal(lt_.tri[5].numpy(), np.asarray(lj.tri[5])[0])
    assert np.array_equal(ht.coarse_inv.numpy(),
                          np.asarray(hj.coarse_inv).reshape(ht.coarse_inv.shape))


@pytest.mark.parametrize("gen,dims", [
    (lambda M: M.sparse.laplacian_3d(8), (8, 8, 8)),
    (lambda M: M.sparse.laplacian_2d(16), (1, 16, 16)),
    (lambda M: M.sparse.anisotropic_poisson_2d(16, epsilon=0.01), (1, 16, 16))])
def test_phat_identity_and_bitwise(gen, dims):
    """P·ec == P̂·broadcast(ec) exactly, and P̂ is JAX's."""
    from lssp_tpu_torch.amg import rs
    hier = rs.rs_host_setup(gen(T))
    lev = next(lev for lev in hier.levels if lev.agg is not None)
    ldims, axis = lev.agg[2], lev.agg[1]
    Phat = trs.phat_from_p(lev.P, lev.grp, ldims, axis)
    ec = np.random.default_rng(0).standard_normal(lev.P.shape[1])
    assert np.abs(Phat @ ec[lev.grp] - lev.P @ ec).max() == 0.0
    Pj = jrs.phat_from_p(lev.P, lev.grp, ldims, axis)
    assert (Phat != Pj).nnz == 0 and np.array_equal(Phat.indices, Pj.indices)


def test_feasibility_gates_and_non_lattice():
    for dims, axis, P in (((16, 16, 16), 0, 8), ((16, 16, 16), 1, 8), ((16, 16, 16), 2, 8),
                          ((15, 16, 16), 0, 8), ((8, 16, 16), 0, 8), ((32, 16, 16), 0, 8),
                          ((1, 6, 10), 1, 4), ((3, 4, 6), 2, 3)):
        assert trs.axis_feasible(dims, axis, P) == jrs.axis_feasible(dims, axis, P)
    assert trs.build_dist_rs(_non_lattice(T, seed_r=2, n=512), 8) is None


def test_spike_solves_match_scipy_and_jax(mesh8):
    """The prepared Spike solve equals the unprepared one and scipy's solve;
    the host spikes and interface inverse are JAX's."""
    from lssp_tpu.ops.tridiag import spike_interface_host as jspike
    n, Pn = 256, 8
    rng = np.random.default_rng(1)
    d = 4.0 + rng.uniform(0, 1, n)
    dl = np.zeros(n)
    dl[1:] = -rng.uniform(0.5, 1.0, n - 1)
    du = np.zeros(n)
    du[:-1] = -rng.uniform(0.5, 1.0, n - 1)
    b = rng.standard_normal(n)
    parts = [a.reshape(Pn, -1) for a in (dl, d, du)]
    v, w, Minv = ttri.spike_interface_host(*parts)
    for a, c in zip((v, w, Minv), jspike(*parts)):
        assert np.array_equal(a, np.asarray(c))
    t = [torch.from_numpy(a) for a in parts]
    x0 = ttri.dist_pcr_solve(*t, torch.from_numpy(b.reshape(Pn, -1))).reshape(-1).numpy()
    x1 = ttri.dist_spike_solve(*t, torch.from_numpy(v), torch.from_numpy(w),
                               torch.from_numpy(Minv),
                               torch.from_numpy(b.reshape(Pn, -1))).reshape(-1).numpy()
    ref = sp.linalg.spsolve(sp.diags([dl[1:], d, du[:-1]], [-1, 0, 1]).tocsc(), b)
    assert np.abs(x1 - ref).max() < 1e-10
    np.testing.assert_allclose(x1, x0, rtol=1e-10, atol=1e-12)
    B = np.stack([b, -2 * b], axis=1).reshape(Pn, -1, 2)
    X = ttri.dist_spike_solve(*t, torch.from_numpy(v), torch.from_numpy(w),
                              torch.from_numpy(Minv), torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X.reshape(n, 2), np.stack([x1, -2 * x1], axis=1),
                               rtol=1e-12, atol=1e-13)
