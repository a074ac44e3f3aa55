"""The communication-avoiding methods of lssp_tpu_torch (pipecg; cagmres and
cargmres, GMRES with twice-iterated classical Gram-Schmidt) against
lssp_tpu on the CPU, on one device and on a mesh of 8 CPU slots.

Tolerances (``test_torch_krylov_common``): counts JAX's ±1 and x to 1e-8
relative at the same count on ``laplacian_2d(32)`` (ILU exact); the
per-column form's counts JAX's ±1 per column; ``solve_ir`` JAX's ±2; JAX's
``tests/test_dist.py: TestCommAvoiding`` systems (pipecg within 2 of cg,
cagmres within 2 of gmres) and its distributed systems (counts ±1, x to
1e-8).  The grouped reductions go through ``solvers/base.dot_many`` /
``dot_rows``: through a dot's ``.many`` / ``.rows`` where it has them (the
distributed dot: one ``psum`` for the group, counted here), else through
that dot once a pair, never a local sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.parallel import dist_solve as jsolve
import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import dist_ops
from lssp_tpu_torch.solvers import base as tbase
from lssp_tpu_torch.solvers.registry import BATCHED_SOLVERS, SOLVERS, get_solver
from test_torch_dist import cpu_mesh, mesh8  # noqa: F401 (a fixture)
from test_torch_krylov_common import batched, parity, refinement

CASES = [("pipecg", "none"), ("pipecg", "iluk"), ("cagmres", "none"), ("cagmres", "iluk"),
         ("cagmres", "ilut"), ("cargmres", "none"), ("cargmres", "iluk")]


@pytest.mark.parametrize("method,pc", CASES, ids=[f"{m}+{p}" for m, p in CASES])
def test_matches_jax_solve(method, pc):
    parity(method, pc, restart=30)


@pytest.mark.parametrize("method", ["pipecg", "cagmres", "cargmres"])
def test_batched_matches_jax_vmap(method):
    assert method in SOLVERS and method in BATCHED_SOLVERS
    batched(method, restart=30)


@pytest.mark.parametrize("method", ["pipecg", "cagmres"])
def test_solve_ir_matches_jax(method):
    """``solve_ir`` (cagmres runs as cargmres inside, as in JAX) and
    ``solve_ir_multi`` per column."""
    refinement(method)


@pytest.mark.parametrize("gen,pc", [("laplacian_2d_64", "jacobi"), ("laplacian_3d_16", "ilu0")])
def test_pipecg_against_cg_and_jax(gen, pc):
    """``TestCommAvoiding.test_pipecg_matches_cg``: pipecg within 2 of cg
    (the norm known one reduction late), relres 1.1e-8; JAX's pipecg ±1."""
    N = int(gen.split("_")[-1])
    mk = {"laplacian_2d": lambda M: M.sparse.laplacian_2d(N),
          "laplacian_3d": lambda M: M.sparse.laplacian_3d(N)}[gen.rsplit("_", 1)[0]]
    Aj, At = mk(J), mk(T)
    n = At.shape[0]
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    po = dict(ilu_sweeps=0)
    _, i1 = T.solve(At, torch.ones(n, dtype=torch.float64), method="cg", pc=pc,
                    options=T.SolverOptions(**o), pc_options=T.PCOptions(**po))
    x2, i2 = T.solve(At, torch.ones(n, dtype=torch.float64), method="pipecg", pc=pc,
                     options=T.SolverOptions(**o), pc_options=T.PCOptions(**po))
    _, ij = J.solve(Aj, jnp.ones(n), method="pipecg", pc=pc, options=J.SolverOptions(**o),
                    pc_options=J.PCOptions(**po))
    assert i2.converged and abs(i2.nits - i1.nits) <= 2 and abs(i2.nits - int(ij.nits)) <= 1
    res = np.linalg.norm(1.0 - At.to_scipy() @ x2.numpy())
    assert res <= 1.1e-8 * i2.r0norm + 1e-10


def test_cagmres_against_gmres_and_jax():
    """``TestCommAvoiding.test_cagmres_matches_gmres``: convection-diffusion
    48², gmres(30) + ilut; each CGS2 variant within 2 of its MGS one and
    JAX's own ±1."""
    Aj, At = J.sparse.convection_diffusion_2d(48), T.sparse.convection_diffusion_2d(48)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000, restart=30)
    b = torch.ones(At.shape[0], dtype=torch.float64)
    for base, ca in (("gmres", "cagmres"), ("rgmres", "cargmres")):
        _, i1 = T.solve(At, b, method=base, pc="ilut", options=T.SolverOptions(**o))
        x2, i2 = T.solve(At, b, method=ca, pc="ilut", options=T.SolverOptions(**o))
        _, ij = J.solve(Aj, jnp.ones(At.shape[0]), method=ca, pc="ilut",
                        options=J.SolverOptions(**o))
        assert i2.converged and abs(i2.nits - i1.nits) <= 2
        assert abs(i2.nits - int(ij.nits)) <= 1
        res = np.linalg.norm(1.0 - At.to_scipy() @ x2.numpy())
        assert res <= 1.1e-8 * i2.r0norm + 1e-10


class CountingDot:
    """A custom inner product without ``.many`` / ``.rows``: counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, a, b):
        self.calls += 1
        return tbase.dot(a, b)


def test_grouped_reductions_fall_back_through_the_dot():
    """A dot without ``.many`` gets one call a pair from ``dot_many`` and one
    a row from ``dot_rows``; with them, the group goes through them once;
    the base dot's ``.rows`` equals its per-row calls bitwise."""
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.standard_normal((4, 50)))
    w = torch.from_numpy(rng.standard_normal(50))
    d = CountingDot()
    out = tbase.dot_many(d, ((V[0], w), (V[1], w), (w, w)))
    assert d.calls == 3 and torch.equal(out[2], tbase.dot(w, w))
    d.calls = 0
    rows = tbase.dot_rows(d, V, w)
    assert d.calls == 4
    assert torch.equal(rows, tbase.dot_rows(tbase.dot, V, w))
    Vk, wk = torch.from_numpy(rng.standard_normal((4, 50, 3))), torch.from_numpy(
        rng.standard_normal((50, 3)))
    assert torch.equal(tbase.dot_rows(tbase.dot, Vk, wk),
                       torch.stack([tbase.dot(Vk[j], wk) for j in range(4)]))
    A = T.sparse.laplacian_2d(16)
    b = torch.ones(256, dtype=torch.float64)
    opts = T.SolverOptions(maxit=12, rtol=1e-14, atol=0, rbtol=0).resolved()
    for name, per_it in (("pipecg", 3), ("cagmres", None)):
        d = CountingDot()
        x, info = get_solver(name)(A.to("cpu"), b, opts=opts, dot=d)
        assert d.calls > info.nits
        ref = get_solver(name)(A.to("cpu"), b, opts=opts)[0]
        assert torch.equal(x, ref)
        if per_it:                      # + ‖b‖, ‖r0‖ and the final ‖r‖
            assert d.calls == per_it * info.nits + 3


class PsumCount:
    def __init__(self, monkeypatch):
        self.calls = 0
        orig = dist_ops.psum

        def counted(partials):
            self.calls += 1
            return orig(partials)
        monkeypatch.setattr(dist_ops, "psum", counted)


def test_one_stacked_reduction(monkeypatch):
    """The distributed dot's ``.many`` sums every pair's per-shard partials in
    ONE ``psum``, ``.rows`` the whole coefficient vector in one, and both
    equal their per-pair sums: pipecg over 8 shards makes one ``psum`` an
    iteration (and one each for ‖b‖, ‖r0‖ and the final norm), cagmres
    three an Arnoldi column (two CGS2 passes and the norm) where MGS pays
    i + 2."""
    count = PsumCount(monkeypatch)
    pdot = dist_ops.make_psum_dot(8)
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(64)) for _ in range(2))
    V = torch.from_numpy(rng.standard_normal((5, 64)))
    g = pdot.many(((a, b), (b, b), (a, a)))
    assert count.calls == 1
    for got, ref in zip(g, (pdot(a, b), pdot(b, b), pdot(a, a))):
        assert torch.equal(got, ref)
    count.calls = 0
    rows = pdot.rows(V, a)
    assert count.calls == 1
    assert torch.equal(rows, torch.stack([pdot(V[j], a) for j in range(5)]))
    A = T.sparse.laplacian_2d(32)
    b1 = torch.ones(1024, dtype=torch.float64)
    o = T.SolverOptions(maxit=2000, restart=30)
    count.calls = 0
    x, info = T.dist_solve(A, b1, method="pipecg", pc="jacobi", mesh=cpu_mesh(), options=o)
    assert info.converged and count.calls == info.nits + 3
    count.calls = 0
    x, info = T.dist_solve(A, b1, method="cagmres", pc="jacobi", mesh=cpu_mesh(),
                           options=T.SolverOptions(maxit=30, restart=30, rtol=1e-14, atol=0))
    # one cycle: 30 Arnoldi columns a 3 psums, plus ‖b‖, ‖r0‖, the cycle's
    # ‖z0‖ and the true residual after it
    assert info.nits == 30 and count.calls == 3 * 30 + 4


DIST = [("pipecg", "laplacian_2d"), ("cagmres", "convdiff"), ("cargmres", "convdiff")]


@pytest.mark.parametrize("method,system", DIST)
def test_dist_solve_matches_jax(method, system, mesh8):
    """``TestDistMethodMatrix``'s systems (32², block-Jacobi ILU, exact) over
    8 shards: JAX's count ±1 and x to 1e-8."""
    mk = {"laplacian_2d": lambda M: M.sparse.laplacian_2d(32),
          "convdiff": lambda M: M.sparse.convection_diffusion_2d(32, beta=10.0)}[system]
    Aj, At = mk(J), mk(T)
    kw = dict(method=method, pc="bjilu")
    xj, ij = jsolve.dist_solve(Aj, jnp.ones(1024), mesh=mesh8,
                               options=J.SolverOptions(maxit=2000, restart=30),
                               pc_options=J.PCOptions(ilu_sweeps=0), **kw)
    xt, it = T.dist_solve(At, torch.ones(1024, dtype=torch.float64), mesh=cpu_mesh(),
                          options=T.SolverOptions(maxit=2000, restart=30),
                          pc_options=T.PCOptions(ilu_sweeps=0), **kw)
    assert it.converged and bool(ij.converged) and abs(it.nits - int(ij.nits)) <= 1
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)
    res = float(np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()))
    assert res < 1e-4


@pytest.mark.parametrize("method", ["pipecg", "cagmres"])
def test_dist_solve_ir_matches_jax(method, mesh8):
    """``dist_solve_ir`` with block-Jacobi ILU(0) (6 sweeps) on 16³ over 8
    shards: JAX's inner count ±1, relres 1e-8."""
    Aj, At = J.sparse.laplacian_3d(16), T.sparse.laplacian_3d(16)
    kw = dict(method=method, pc="bjilu")
    _, ij = jsolve.dist_solve_ir(Aj, jnp.ones(4096), mesh=mesh8,
                                 options=J.SolverOptions(rtol=1e-8, atol=0, restart=30),
                                 pc_options=J.PCOptions(ilu_sweeps=6), **kw)
    xt, it = T.dist_solve_ir(At, torch.ones(4096, dtype=torch.float64), mesh=cpu_mesh(),
                             options=T.SolverOptions(rtol=1e-8, atol=0, restart=30),
                             pc_options=T.PCOptions(ilu_sweeps=6), **kw)
    assert it.converged and abs(it.nits - int(ij.nits)) <= 1, (it.nits, int(ij.nits))
    assert np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) / 64 <= 1e-8


def test_dist_multi_per_column():
    """``dist_solve_multi`` pipecg per column over 8 shards: each column its
    single distributed solve's count ±1."""
    A = T.sparse.laplacian_2d(16)
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((256, 3)))
    o = T.SolverOptions(maxit=500)
    X, info = T.dist_solve_multi(A, B, method="pipecg", pc="jacobi", mesh=cpu_mesh(), options=o)
    singles = [T.dist_solve(A, B[:, c], method="pipecg", pc="jacobi", mesh=cpu_mesh(),
                            options=o)[1].nits for c in range(3)]
    assert info.converged.all() and np.all(np.abs(info.nits - np.array(singles)) <= 1)
