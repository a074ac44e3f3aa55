"""The general Krylov methods of lssp_tpu_torch against lssp_tpu on the CPU:
the shared checks, and the shared parts of ``test_torch_krylov_*.py``.

Here: the IDR(s) shadow space (the port's draw equals
``jax.random.uniform(PRNGKey(0), (s, n), dtype)`` bitwise, and after MGS
agrees with JAX's to 1e-15 in fp64 and 1e-6 in fp32), the registry, and
``_inner_plan`` (the same inner method and options as JAX's for every
name both registries hold).

The method files use ``parity``, ``ratchet_100`` and ``batched``: on the
2-D Laplacian at N=32 (b = 1, x0 = 0, restart 60, ``ilu_sweeps`` pinned to
0) counts are JAX's ±1 and x agrees to 1e-8 relative at the same number
of iterations; every
``tests/golden/ratchet.json`` key is held to recorded + max(2, 5 %) (a
``ULP_KEYS`` key to at least JAX's own maximum under 1-ulp changes of b,
+ 1), at N=32 against JAX and at N=100 (maxit 3000) by the port alone, with the
golden true-residual bound of ``tests/test_solvers.py:run_config``; the
per-column batched form runs 3 seeded columns on ``laplacian_2d(24)``
with ILU(k) against JAX's ``solve_multi`` (``vmap``), each column's count
JAX's ±1, and a column converged at x0 (b = 0) keeps JAX's count and is
left bitwise unchanged.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
import lssp_tpu_torch as T
from lssp_tpu.solvers import refine as jrefine
from lssp_tpu_torch.solvers import _threefry
from lssp_tpu_torch.solvers import refine as trefine
from lssp_tpu_torch.solvers.idrs import shadow_space

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN_DIR, "ratchet.json")) as f:
    RATCHET = json.load(f)


def _golden(name):
    out = {}
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        for line in f:
            rec = json.loads(line.replace("-nan", "NaN").replace("nan", "NaN"))
            out[(rec["solver"], rec["pc"])] = rec
    return out


GOLDEN = {32: _golden("laplacian32.jsonl"), 100: _golden("laplacian100.jsonl")}
NEW = ["cgs", "cr", "crs", "bicrstab", "bicgsafe", "bicrsafe", "gpbicg", "gpbicr",
       "qmrcgstab", "tfqmr", "orthomin", "bicgstabl", "idrs", "lgmres", "rlgmres",
       "minres", "fgmres"]
_A = {}


def lap(N):
    if N not in _A:
        _A[N] = (J.sparse.laplacian_2d(N), T.sparse.laplacian_2d(N))
    return _A[N]


def pcs(method):
    """MINRES needs an SPD M (``tests/test_solvers_extra.py:35-37``)."""
    return ["none", "jacobi", "iluk"] if method == "minres" else ["none", "iluk", "ilut"]


# The ratchet keys whose JAX count itself passes the ratchet limit under
# b = 1 and three 1-ulp changes of b (``scripts/jax_krylov_reference.py
# --ratchet-ulp``): such a count moves with rounding alone, so the key is
# held to JAX's maximum over those four b's + 1, computed here.
ULP_KEYS = {"bicgstab+none@100", "bicrstab+none@100", "qmrcgstab+none@100"}


def ulp_rhs(n, seed):
    """b = 1 with three entries one ulp up (seed None: b = 1), as the
    script makes them."""
    b = np.ones(n)
    if seed is not None:
        b[np.random.default_rng(seed).integers(0, n, 3)] = np.nextafter(1.0, 2.0)
    return b


def jax_ulp_max(key):
    """JAX's largest count on ``key`` under b = 1 and the 1-ulp changes of
    seeds 1-3."""
    mp, N = key.split("@")
    method, pc = mp.split("+")
    N = int(N)
    o = J.SolverOptions(restart=60, maxit=2000 if N == 32 else 3000)
    return max(int(J.solve(lap(N)[0], jnp.asarray(ulp_rhs(N * N, seed)), method=method,
                           pc=pc, options=o, pc_options=pc_opts(J, pc, N))[1].nits)
               for seed in (None, 1, 2, 3))


def held(key, nits):
    """The ratchet: recorded + max(2, 5 %); a ``ULP_KEYS`` key at least
    JAX's own 1-ulp maximum + 1."""
    if key in RATCHET:
        lim = RATCHET[key] + max(2, int(np.ceil(0.05 * RATCHET[key])))
        if key in ULP_KEYS:
            lim = max(lim, jax_ulp_max(key) + 1)
        assert nits <= lim, f"{key}: {nits} iterations, limit {lim}"


def true_res_ok(method, pc, N, x):
    """``run_config``'s bound: twice the reference's true residual, or the
    stopping rule's 1.1e-7·√n·4 (also for its NaN-x class)."""
    A = lap(N)[1]
    res = np.linalg.norm(1.0 - A.to_scipy() @ x)
    rec = GOLDEN[N].get((method, pc))
    bound = 1.1e-7 * N * 4
    if rec is not None and np.isfinite(rec["true_residual"]):
        bound = max(bound, 2.0 * rec["true_residual"])
    assert np.isfinite(x).all() and res <= bound, f"{method}+{pc}@{N}: true residual {res}"


def pc_opts(M, pc, N):
    """The ratchet's PC options in package M: ILU exact; ``biluk`` with
    n / 4 blocks (4×4 blocks, ``tests/test_solvers.py: test_biluk``)."""
    return M.PCOptions(ilu_sweeps=0, num_blocks=N * N // 4 if pc == "biluk" else None)


def parity(method, pc, N=32, **kw):
    """Both packages' ``solve`` on the 2-D Laplacian, b = 1, restart 60 unless
    given, ILU exact: counts ±1, x to 1e-8 at the same number of iterations
    (when the counts differ, the solve that took more is run again with
    ``maxit`` at the other's count), the N=32 ratchet key held."""
    Aj, At = lap(N)
    o = dict(restart=60, maxit=2000)
    o.update(kw)

    def jax_solve(**extra):
        return J.solve(Aj, jnp.ones(N * N), method=method, pc=pc,
                       options=J.SolverOptions(**{**o, **extra}),
                       pc_options=pc_opts(J, pc, N))

    def port_solve(**extra):
        return T.solve(At, torch.ones(N * N, dtype=torch.float64), method=method, pc=pc,
                       options=T.SolverOptions(**{**o, **extra}),
                       pc_options=pc_opts(T, pc, N))
    xj, ij = jax_solve()
    xt, it = port_solve()
    assert isinstance(it.nits, int) and isinstance(it.converged, bool)
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 1, (it.nits, int(ij.nits))
    true_res_ok(method, pc, N, xt.numpy())
    if not kw:
        held(f"{method}+{pc}@{N}", it.nits)
    if it.nits > int(ij.nits):
        xt, _ = port_solve(maxit=int(ij.nits))
    elif it.nits < int(ij.nits):
        xj, _ = jax_solve(maxit=it.nits)
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def ratchet_100(method, pc):
    """The port alone on the N=100 ratchet key (maxit 3000, restart 60)."""
    At = lap(100)[1]
    x, info = T.solve(At, torch.ones(10000, dtype=torch.float64), method=method, pc=pc,
                      options=T.SolverOptions(restart=60, maxit=3000),
                      pc_options=pc_opts(T, pc, 100))
    assert info.converged
    true_res_ok(method, pc, 100, x.numpy())
    held(f"{method}+{pc}@100", info.nits)


def batched(method, **kw):
    """``solve_multi`` per column against JAX's vmapped solve on 3 seeded
    columns, then with column 1 zero (converged at x0 = 0)."""
    Aj, At = J.sparse.laplacian_2d(24), T.sparse.laplacian_2d(24)
    B = np.random.default_rng(7).standard_normal((576, 3))
    o = dict(restart=60, maxit=2000)
    o.update(kw)
    for Bc in (B, B * np.array([1.0, 0.0, 1.0])):
        Xj, ij = J.solve_multi(Aj, jnp.asarray(Bc), method=method, pc="iluk",
                               options=J.SolverOptions(**o),
                               pc_options=J.PCOptions(ilu_sweeps=0))
        Xt, it = T.solve_multi(At, torch.from_numpy(Bc), method=method, pc="iluk",
                               options=T.SolverOptions(**o),
                               pc_options=T.PCOptions(ilu_sweeps=0))
        nj = np.asarray(ij.nits)
        assert it.nits.shape == (3,) and np.all(np.abs(it.nits - nj) <= 1), (it.nits, nj)
        assert it.converged.all() and np.asarray(ij.converged).all()
        Xj = np.asarray(Xj)
        for c in (0, 2):
            assert np.linalg.norm(Xt[:, c].numpy() - Xj[:, c]) <= 1e-8 * np.linalg.norm(Xj[:, c])
    assert it.nits[1] == nj[1]                     # the zero column stops on its own
    assert torch.equal(Xt[:, 1], torch.zeros(576, dtype=torch.float64))


def refinement(method, rel=0.0):
    """``solve_ir`` and ``solve_ir_multi`` (fp64 out, fp32 in, ILU(k) exact)
    on ``laplacian_2d(32)``: total inner counts JAX's ±max(2, rel·JAX's),
    per column."""
    Aj, At = lap(32)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    kj = dict(method=method, pc="iluk", options=J.SolverOptions(**o),
              pc_options=J.PCOptions(ilu_sweeps=0))
    kt = dict(method=method, pc="iluk", options=T.SolverOptions(**o),
              pc_options=T.PCOptions(ilu_sweeps=0))
    xj, ij = J.solve_ir(Aj, jnp.ones(1024), **kj)
    xt, it = T.solve_ir(At, torch.ones(1024, dtype=torch.float64), **kt)
    def close(nt, nj):
        return np.all(np.abs(nt - nj) <= np.maximum(2, np.ceil(rel * nj)))

    assert it.converged and bool(ij.converged) and close(it.nits, int(ij.nits)), \
        (it.nits, int(ij.nits))
    assert np.linalg.norm(1.0 - At.to_scipy() @ xt.numpy()) <= 1e-8 * 32
    B = np.random.default_rng(5).standard_normal((1024, 3))
    Xj, ij = J.solve_ir_multi(Aj, jnp.asarray(B), **kj)
    Xt, it = T.solve_ir_multi(At, torch.from_numpy(B), **kt)
    assert it.converged.all() and close(it.nits, np.asarray(ij.nits)), (it.nits, ij.nits)
    res = np.linalg.norm(B - At.to_scipy() @ Xt.numpy(), axis=0)
    assert np.all(res <= 1e-8 * np.linalg.norm(B, axis=0))


def distributed(method, mesh8):
    """``dist_solve`` with block-Jacobi ILU on 8 shards (the port's 8-slot
    CPU mesh, JAX's ``mesh8``) on ``laplacian_2d(16)``: counts ±2, x to
    1e-8 (``tests/test_torch_dist.py``'s tolerances)."""
    from lssp_tpu.parallel import dist_solve as jsolve
    Aj, At = J.sparse.laplacian_2d(16), T.sparse.laplacian_2d(16)
    xj, ij = jsolve.dist_solve(Aj, jnp.ones(256), method=method, pc="bjilu", mesh=mesh8,
                               options=J.SolverOptions(maxit=3000),
                               pc_options=J.PCOptions(ilu_sweeps=0))
    xt, it = T.dist_solve(At, torch.ones(256, dtype=torch.float64), method=method, pc="bjilu",
                          mesh=T.make_mesh(8, devices=[torch.device("cpu")] * 8),
                          options=T.SolverOptions(maxit=3000),
                          pc_options=T.PCOptions(ilu_sweeps=0))
    assert it.converged and bool(ij.converged) and abs(it.nits - int(ij.nits)) <= 2
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


@pytest.fixture(scope="module")
def mesh8():
    from lssp_tpu.parallel import dist_solve as jsolve
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


# ---- the shadow space --------------------------------------------------------

DRAWS = [(s, n, dt) for s in (1, 2, 4, 8) for n in (1, 7, 1024, 4097)
         for dt in ("float32", "float64")]


@pytest.mark.parametrize("s,n,dt", DRAWS, ids=[f"{s}x{n}-{d}" for s, n, d in DRAWS])
def test_shadow_draw_is_jax_bitwise(s, n, dt):
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (s, n), dtype=getattr(jnp, dt)))
    got = _threefry.uniform((s, n), getattr(torch, dt)).numpy()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def _jax_orth(P):
    """``lssp_tpu/solvers/idrs.py:37-44``."""
    s = P.shape[0]

    def orth_body(j, P):
        pj = P[j] / jnp.sqrt(jnp.dot(P[j], P[j]))
        P = P.at[j].set(pj)

        def inner(i, P):
            d = jnp.dot(pj, P[i])
            return jax.lax.cond(i > j, lambda P: P.at[i].set(P[i] - d * pj), lambda P: P, P)
        return jax.lax.fori_loop(0, s, inner, P)
    return jax.lax.fori_loop(0, s, orth_body, P)


@pytest.mark.parametrize("s,n,dt", [(s, n, d) for s in (1, 2, 4, 8) for n in (1024, 4097)
                                    for d in ("float32", "float64")])
def test_shadow_space_after_mgs(s, n, dt):
    ref = np.asarray(_jax_orth(jax.random.uniform(jax.random.PRNGKey(0), (s, n),
                                                  dtype=getattr(jnp, dt))))
    got = shadow_space(s, n, getattr(torch, dt), "cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15 if dt == "float64" else 1e-6)
    tiled = shadow_space(s, 2 * n, getattr(torch, dt), "cpu", shards=2).numpy()
    assert np.array_equal(tiled, np.concatenate([got, got], axis=1))


# ---- the registry and the solve_ir inner plan ---------------------------------

TRANSPOSE = ["bicg", "qmr", "cgnr", "cgn", "lsqr"]
ONE_BODY = ["pipecg", "direct", "splu"]        # one function for both forms
CGS2 = ["cagmres", "cargmres"]


def test_registry_holds_the_ported_methods():
    assert sorted(T.solvers.SOLVERS) == sorted(["cg", "gmres", "rgmres", "bicgstab"] + NEW
                                               + TRANSPOSE + ONE_BODY + CGS2)
    assert sorted(T.solvers.SOLVERS) == sorted(J.solvers.registry.SOLVERS)
    for name in NEW + TRANSPOSE + ONE_BODY:
        assert T.solvers.get_batched_solver(name) is T.solvers.get_solver(name)
    for name in CGS2:
        assert name in T.solvers.BATCHED_SOLVERS


def _names(fn, table):
    return fn.__name__, sorted(k for k, v in table.items() if v is fn)


@pytest.mark.parametrize("method", sorted(set(T.solvers.SOLVERS) & set(J.solvers.SOLVERS))
                         + ["blockcg", "blockgmres"])
def test_inner_plan_matches_jax(method):
    """The same inner method and options as JAX's; the normal-equation
    methods (cgnr, cgn, lsqr) alone take the whole maxit as their inner cap
    where JAX caps them at 200 (``refine._inner_plan``)."""
    for restart in (20, 50):
        fj, oj = jrefine._inner_plan(method, J.SolverOptions(restart=restart).resolved(), 1e-3)
        ft, ot = trefine._inner_plan(method, T.SolverOptions(restart=restart).resolved(), 1e-3,
                                     multi=method.startswith("block"))
        assert _names(ft, T.solvers.SOLVERS) == _names(fj, J.solvers.SOLVERS)
        if method in trefine.NORMAL_EQUATION_METHODS:
            assert (oj.maxit, ot.maxit) == (200, T.SolverOptions().resolved().maxit)
            oj = dataclasses.replace(oj, maxit=ot.maxit)
        assert dataclasses.asdict(ot) == dataclasses.asdict(oj)


FIRST = [(m, p) for m in ("cg", "gmres", "rgmres", "bicgstab") for p in ("none", "iluk", "ilut")
         if (m, p) != ("cg", "ilut")]


@pytest.mark.parametrize("method,pc", FIRST, ids=[f"{m}+{p}@100" for m, p in FIRST])
def test_ratchet_100_first_methods(method, pc):
    """The N=100 ratchet keys of the first slice's methods (their N=32 keys
    are held by ``tests/test_torch_solvers.py``)."""
    ratchet_100(method, pc)
