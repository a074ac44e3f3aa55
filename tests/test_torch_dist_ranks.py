"""The distributed slice of lssp_tpu_torch over several processes: gloo ranks
on the CPU, one ``Mesh`` over W ranks (W = 1, 2, 4) with 8 / W shards each,
8 global shards, against the one-process ``cpu_mesh(8)`` run of the same
cases and against JAX's 8-device mesh.

One spawn per W runs every case in W worker processes (this file, run as
a script with ``--worker``), each with one thread, a ``file://``
rendezvous under a temporary directory and a group timeout of 120 s; the
parent waits as long and kills the workers after, so a hang fails the
tests and cannot stall the run.  The one-process reference runs in the
parent, also with one thread (torch's and the host BLAS / LAPACK's).

Held bitwise (x and the iteration count equal): the halo exchange (DIA,
and the masked ELL one), the DIA / HYB / ELL-halo / ELL-all-gather
forward products on (n,) and (n, k), the psum dot with ``.many`` and
``.rows``, the Spike tridiagonal solve (also within 1e-12 of scipy's
banded solve), and the solves in ``BITWISE`` and ``AMG``: every reduction
is the one-process sum of the same per-shard partials, and every AMG
coarse solve and Spike interface product is the one-process product, formed
whole on every rank.  To rounding: the transposes (rtol 1e-13: the
all-gather paths reduce over ranks in another order), and the solves in
``ROUNDED`` and ``AMG_ROUNDED`` (x within 1e-10 relative, counts ±1: the
transposes, the stacked exact schedules, the block methods' Grams summed
per rank).  At W = 1 every solve is bitwise the group-less mesh's.
Against JAX: ``tests/test_torch_dist.py``'s bounds (±2 iterations, x within
1e-8 relative).
"""
import datetime
import importlib
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import multihost
from lssp_tpu_torch.parallel.dist_ops import (gather_rows, halo_exchange, make_dist_spmv,
                                              make_dist_spmv_t, make_psum_dot)
from lssp_tpu_torch.parallel.partition import partition_matrix

# the module (``lssp_tpu_torch.parallel`` re-exports a function of its name)
tsolve = importlib.import_module("lssp_tpu_torch.parallel.dist_solve")

NSHARDS = 8
WORLDS = (1, 2, 4)
TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nearly_banded(n_side=16, n_extra=40, seed=4):
    """tests/test_torch_dist.py:nearly_banded, from the port's generator."""
    rng = np.random.default_rng(seed)
    S = T.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] += 0.02
    S = sp.csr_matrix(S.tocsr())
    S.sort_indices()
    return T.CSR.from_scipy(S)


def non_lattice(n=1024, seed=4):
    """tests/test_torch_dist_amg.py:_non_lattice: a random graph Laplacian
    plus a shift, no grid (rsamg falls back to saamg on it)."""
    R = sp.random(n, n, density=0.008, random_state=seed)
    W = -(abs(R) + abs(R.T))
    W = W - sp.diags(W.diagonal())
    return T.CSR.from_scipy((W + sp.diags(-np.asarray(W.sum(axis=1)).ravel() + 0.05)).tocsr())


MATRICES = {
    "lap2": lambda: T.sparse.laplacian_2d(32),
    "lap2_30": lambda: T.sparse.laplacian_2d(30),
    "lap3": lambda: T.sparse.laplacian_3d(16),
    "aniso32": lambda: T.sparse.anisotropic_poisson_2d(32, epsilon=0.01),
    # lines along x cut mid-row by the shard cuts (test_torch_dist_amg.py's
    # misaligned-grid matrix)
    "aniso36": lambda: T.sparse.anisotropic_poisson_2d(36, epsilon=0.01),
    "convdiff": lambda: T.sparse.convection_diffusion_2d(32, beta=10.0),
    "nearly_banded": nearly_banded,
    "non_lattice": non_lattice,
    "random": lambda: T.sparse.random_sparse(64, 6),
}


def rhs(n, k=None, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n if k is None else (n, k)))


def own_rows(x, mesh):
    """This rank's rows of a whole (n[, k]) tensor."""
    n_loc = x.shape[0] // mesh.world
    return x[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]


def own_shards(M, mesh):
    return M.local(mesh.rank * mesh.slots, (mesh.rank + 1) * mesh.slots)


# ---------------------------------------------------------------------------
# the cases: each takes a mesh and returns whole tensors, the same on every
# rank; run by the workers over W ranks and by the parent on one process
# ---------------------------------------------------------------------------

def halo_case(lo, hi, k, wrap):
    def run(mesh):
        R = 32
        x2 = rhs(NSHARDS * R, k, seed=2).view(NSHARDS, R, *(() if k is None else (k,)))
        local = x2[mesh.rank * mesh.slots:(mesh.rank + 1) * mesh.slots]
        return {"y": gather_rows(halo_exchange(local, lo, hi, mesh, wrap=wrap), mesh)}
    return run


def product_case(name, fmt, k, transpose):
    def run(mesh):
        A = MATRICES[name]()
        M = own_shards(partition_matrix(A, NSHARDS, fmt=fmt), mesh)
        make = make_dist_spmv_t if transpose else make_dist_spmv
        y = make(M, mesh)(own_rows(rhs(A.shape[0], k, seed=3), mesh))
        return {"y": gather_rows(y, mesh)}
    return run


def dot_case(kind):
    def run(mesh):
        n = NSHARDS * 40
        pdot = make_psum_dot(mesh.slots, mesh)
        if kind == "vector":
            x, y = own_rows(rhs(n, seed=4), mesh), own_rows(rhs(n, seed=5), mesh)
            return {"y": pdot(x, y)}
        if kind == "block":
            X, Y = own_rows(rhs(n, 3, seed=4), mesh), own_rows(rhs(n, 3, seed=5), mesh)
            return {"y": pdot(X, Y)}
        vs = [own_rows(rhs(n, seed=s), mesh) for s in range(6, 10)]
        if kind == "many":
            return {"y": torch.stack(pdot.many([(vs[0], vs[1]), (vs[2], vs[3]), (vs[1], vs[1])]))}
        return {"y": pdot.rows(torch.stack(vs[:3]), vs[3])}
    return run


def solve(name, entry, method, pc, sweeps=6, k=None, fmt="auto", rtol=None, pco=None):
    """A solve case's spec: the matrix, the entry point and its arguments
    (``pco``: more ``PCOptions`` fields)."""
    return dict(name=name, entry=entry, method=method, pc=pc, sweeps=sweeps, k=k, fmt=fmt,
                rtol=rtol, pco=pco or {})


def solve_case(name, entry, method, pc, sweeps, k, fmt, rtol, pco):
    def run(mesh):
        A = MATRICES[name]()
        n = A.shape[0]
        b = torch.ones(n, dtype=torch.float64) if k is None else rhs(n, k, seed=6)
        opts = T.SolverOptions(maxit=3000) if rtol is None else T.SolverOptions(rtol=rtol, atol=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            x, info = getattr(T, entry)(A, b, method=method, pc=pc, mesh=mesh, fmt=fmt,
                                        options=opts,
                                        pc_options=T.PCOptions(ilu_sweeps=sweeps, **pco))
        fallback = any("shard-alignable lattice" in str(w.message) for w in caught)
        (prep,) = A._dist_cache.values()
        return {"x": x, "nits": torch.as_tensor(np.asarray(info.nits)),
                "converged": torch.as_tensor(np.asarray(info.converged)),
                "fallback": torch.tensor(fallback), "n_solved": torch.tensor(prep["n"])}
    return run


def tridiag(n=256, seed=1):
    """A diagonally dominant tridiagonal system (dl, d, du, b) whose every
    coupling crosses the shard cuts it meets."""
    rng = np.random.default_rng(seed)
    d = 4.0 + rng.uniform(0, 1, n)
    dl = np.zeros(n)
    dl[1:] = -rng.uniform(0.5, 1.0, n - 1)
    du = np.zeros(n)
    du[:-1] = -rng.uniform(0.5, 1.0, n - 1)
    return dl, d, du, rng.standard_normal(n)


def spike_case(mesh):
    """The Spike solve of ``tridiag()`` on this rank's shards, for b (n,)
    and a block (n, 2), gathered whole."""
    from lssp_tpu_torch.ops.tridiag import dist_spike_solve, spike_interface_host
    dl, d, du, b = tridiag()
    parts = [a.reshape(NSHARDS, -1) for a in (dl, d, du)]
    v, w, Minv = spike_interface_host(*parts)
    own = slice(mesh.rank * mesh.slots, (mesh.rank + 1) * mesh.slots)
    coeffs = [torch.from_numpy(a[own]) for a in (*parts, v, w)]
    B = np.stack([b, -2 * b], axis=1).reshape(NSHARDS, -1, 2)
    y = dist_spike_solve(*coeffs, torch.from_numpy(Minv),
                         torch.from_numpy(b.reshape(NSHARDS, -1)[own]), mesh)
    Y = dist_spike_solve(*coeffs, torch.from_numpy(Minv), torch.from_numpy(B[own]), mesh)
    return {"y": gather_rows(y, mesh).reshape(-1), "Y": gather_rows(Y, mesh).reshape(-1, 2)}


def shard_case(mesh):
    """``shard_vector`` gives this rank's (P_loc, R) rows of the whole x and
    ``unshard_vector`` gathers the whole x back on every rank."""
    from lssp_tpu_torch.parallel import shard_vector, unshard_vector
    x = rhs(NSHARDS * 24, seed=9)
    xs = shard_vector(x, NSHARDS, mesh)
    return {"y": unshard_vector(xs, mesh), "shape": torch.tensor(xs.shape)}


HALOS = {
    "shard_unshard": shard_case,
    "dia": halo_case(3, 2, None, True),
    "dia_block": halo_case(3, 2, 4, True),
    "ell_masked": halo_case(4, 4, None, False),
    "ell_masked_block": halo_case(4, 4, 3, False),
}
PRODUCTS = [("lap2", "dia"), ("nearly_banded", "hyb"), ("lap2", "halo"),
            ("random", "allgather")]
FORWARD = {f"{name}_{fmt}_{'k3' if k else 'vec'}": product_case(name, fmt, k, False)
           for name, fmt in PRODUCTS for k in (None, 3)}
TRANSPOSED = {f"{name}_{fmt}_{'k3' if k else 'vec'}_t": product_case(name, fmt, k, True)
              for name, fmt in PRODUCTS for k in (None, 3)}
DOTS = {f"psum_{kind}": dot_case(kind) for kind in ("vector", "block", "many", "rows")}
BITWISE = {
    "cg_bjilu": solve("lap2", "dist_solve", "cg", "bjilu"),
    "gmres_bjilu": solve("convdiff", "dist_solve", "gmres", "bjilu"),
    "bicgstab_jacobi_hyb": solve("nearly_banded", "dist_solve", "bicgstab", "jacobi", fmt="hyb"),
    "cg_jacobi_ell_halo": solve("lap2", "dist_solve", "cg", "jacobi", fmt="ell"),
    "gmres_none_allgather": solve("random", "dist_solve", "gmres", "none", fmt="ell"),
    "idrs_jacobi": solve("lap2", "dist_solve", "idrs", "jacobi"),
    "pipecg_bjilu": solve("lap2", "dist_solve", "pipecg", "bjilu"),
    "ir_cg_ilu0": solve("lap3", "dist_solve_ir", "cg", "ilu0", rtol=1e-10),
    "multi_cg_bjilu": solve("lap2", "dist_solve_multi", "cg", "bjilu", k=4),
}
ROUNDED = {
    "bicg_ilu0": solve("convdiff", "dist_solve", "bicg", "ilu0"),
    "qmr_jacobi": solve("convdiff", "dist_solve", "qmr", "jacobi"),
    "cg_ilu_exact": solve("lap2", "dist_solve", "cg", "bjilu", sweeps=0),
    "blockcg_bjilu": solve("lap2", "dist_solve_multi", "blockcg", "bjilu", k=4),
    "blockgmres_jacobi": solve("convdiff", "dist_solve_multi", "blockgmres", "jacobi", k=4),
    "ir_multi_blockcg": solve("lap3", "dist_solve_ir_multi", "blockcg", "ilu0", k=4,
                              rtol=1e-8),
}
AMG = {
    **{f"cg_{pc}": solve("lap2", "dist_solve", "cg", pc) for pc in ("saamg", "rsamg", "amg")},
    "cg_saamg_flat": solve("lap2_30", "dist_solve", "cg", "saamg", pco=dict(saamg_grid=False)),
    "cg_saamg_line": solve("aniso36", "dist_solve", "cg", "saamg",
                           pco=dict(saamg_grid=False, amg_smoother="line")),
    "cg_rsamg_lap3": solve("lap3", "dist_solve", "cg", "rsamg"),
    "cg_rsamg_fallback": solve("non_lattice", "dist_solve", "cg", "rsamg", rtol=1e-8),
    "ir_gmres_saamg": solve("aniso32", "dist_solve_ir", "gmres", "saamg", rtol=1e-8),
}
AMG_ROUNDED = {"blockcg_saamg": solve("lap2", "dist_solve_multi", "blockcg", "saamg", k=4)}
CASES = {**HALOS, **FORWARD, **TRANSPOSED, **DOTS, "spike": spike_case,
         **{c: solve_case(**spec)
            for c, spec in {**BITWISE, **ROUNDED, **AMG, **AMG_ROUNDED}.items()}}


def run_cases(mesh):
    """Every case on ``mesh``: {case: {key: tensor}} or {case: {"error": ...}}.
    Every rank runs the same cases in the same order; a case that raises
    does so on every rank, before any collective."""
    out = {}
    for name, fn in CASES.items():
        try:
            out[name] = fn(mesh)
        except (NotImplementedError, ValueError, RuntimeError) as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def worker(world, rank, rendezvous, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(rendezvous, world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT))
    import torch.distributed as dist
    try:
        res = run_cases(multihost.global_mesh(slots=NSHARDS // world))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: one spawn per W, the one-process reference, the comparisons
# ---------------------------------------------------------------------------

def _spawn(world, tmp):
    out = tmp / f"w{world}"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    procs = []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, "--worker", str(world), str(r),
                                        f"file://{tmp / f'rdv{world}'}", str(out)],
                                       cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    return out, procs


def _collect(world, out, procs, deadline):
    """Each rank's results; raises with the workers' output if a worker
    failed or the deadline passed (every worker is killed then)."""
    failed = False
    while time.monotonic() < deadline and not failed:
        codes = [p.poll() for p, _ in procs]
        if all(c is not None for c in codes):
            break
        failed = any(c not in (None, 0) for c in codes)
        time.sleep(0.1)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        logs = "\n".join((out / f"rank{r}.log").read_text()[-3000:] for r in range(world))
        raise RuntimeError(f"W={world}: worker exit codes {codes}\n{logs}")
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(world)]



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank 0's results, rank 1's, ...]} and the one-process results."""
    from lssp_tpu_torch import native
    native.load()                       # built once here, not by each worker
    tmp = tmp_path_factory.mktemp("ranks")
    spawned = {w: _spawn(w, tmp) for w in WORLDS}
    deadline = time.monotonic() + TIMEOUT + 30
    # one thread, as in the workers: the host LAPACK of block GMRES's least
    # squares rounds by its thread count
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            ref = run_cases(T.make_mesh(NSHARDS, devices=["cpu"] * NSHARDS))
    finally:
        torch.set_num_threads(threads)
    got = {}
    errors = []
    for w, (out, procs) in spawned.items():
        try:
            got[w] = _collect(w, out, procs, deadline)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        pytest.fail("\n".join(errors))
    return got, ref


def ranks_and_ref(runs, world, case):
    got, ref = runs
    per_rank = [g[case] for g in got[world]]
    assert "error" not in ref[case], ref[case]
    for g in per_rank:
        assert "error" not in g, g["error"]
    return per_rank, ref[case]


def assert_same_on_every_rank(per_rank):
    for g in per_rank[1:]:
        for key, v in g.items():
            assert torch.equal(v, per_rank[0][key]), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(HALOS) + list(FORWARD) + list(DOTS))
def test_exchanges_products_and_dots_bitwise(runs, world, case):
    per_rank, ref = ranks_and_ref(runs, world, case)
    assert_same_on_every_rank(per_rank)
    assert torch.equal(per_rank[0]["y"], ref["y"])
    if case == "shard_unshard":
        assert per_rank[0]["shape"].tolist() == [NSHARDS // world, 24]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(TRANSPOSED))
def test_transposes_to_rounding(runs, world, case):
    per_rank, ref = ranks_and_ref(runs, world, case)
    assert_same_on_every_rank(per_rank)
    np.testing.assert_allclose(per_rank[0]["y"].numpy(), ref["y"].numpy(), rtol=1e-13,
                               atol=1e-13 * float(ref["y"].abs().max()))


def assert_bitwise(got, ref):
    assert bool(ref["converged"].all())
    assert torch.equal(got["nits"], ref["nits"])
    assert torch.equal(got["x"], ref["x"])


def assert_rounded(got, ref, world):
    """x within 1e-10 relative and counts ±1; bitwise at W = 1."""
    assert bool(got["converged"].all()) and bool(ref["converged"].all())
    if world == 1:                      # one rank: the group-less mesh's bits
        assert torch.equal(got["x"], ref["x"]) and torch.equal(got["nits"], ref["nits"])
        return
    assert (got["nits"] - ref["nits"]).abs().max() <= 1
    assert float((got["x"] - ref["x"]).norm() / ref["x"].norm()) <= 1e-10


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(BITWISE))
def test_solves_bitwise(runs, world, case):
    per_rank, ref = ranks_and_ref(runs, world, case)
    assert_same_on_every_rank(per_rank)
    assert_bitwise(per_rank[0], ref)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(ROUNDED))
def test_solves_to_rounding(runs, world, case):
    per_rank, ref = ranks_and_ref(runs, world, case)
    assert_same_on_every_rank(per_rank)
    assert_rounded(per_rank[0], ref, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(AMG) + list(AMG_ROUNDED))
def test_amg_over_ranks(runs, world, case):
    """saamg (grid, flat with padding, the line smoother across shard and
    rank cuts), rsamg (lattice, and its saamg fallback, warned on every
    rank) and classical amg over W ranks: x and the count bitwise the
    one-process mesh's; block CG + saamg to rounding."""
    per_rank, ref = ranks_and_ref(runs, world, case)
    assert_same_on_every_rank(per_rank)
    if case in AMG_ROUNDED:
        assert_rounded(per_rank[0], ref, world)
    else:
        assert_bitwise(per_rank[0], ref)
    assert bool(ref["fallback"]) == (case == "cg_rsamg_fallback")
    assert all(bool(g["fallback"]) == bool(ref["fallback"]) for g in per_rank)
    if case in ("cg_saamg_flat", "cg_saamg_line"):
        # the flat plan grew the system to its P·gᴸ multiple; x is cut back
        n = MATRICES[AMG[case]["name"]]().shape[0]
        assert int(ref["n_solved"]) > n and ref["x"].shape == (n,)


@pytest.mark.parametrize("world", WORLDS)
def test_spike_over_ranks(runs, world):
    """The Spike solve over W ranks is bitwise the one-process solve and
    within 1e-12 (absolute, |x| ~ 1) of scipy's banded solve."""
    per_rank, ref = ranks_and_ref(runs, world, "spike")
    assert_same_on_every_rank(per_rank)
    got = per_rank[0]
    assert torch.equal(got["y"], ref["y"]) and torch.equal(got["Y"], ref["Y"])
    dl, d, du, b = tridiag()
    want = sp.linalg.spsolve(sp.diags([dl[1:], d, du[:-1]], [-1, 0, 1]).tocsc(), b)
    assert np.abs(got["y"].numpy() - want).max() <= 1e-12
    assert np.abs(got["Y"].numpy() - np.stack([want, -2 * want], axis=1)).max() <= 2e-12


# JAX's 8-device mesh on the same cases (run once, in the parent)
JAX_CASES = ["cg_bjilu", "gmres_bjilu", "bicgstab_jacobi_hyb", "cg_jacobi_ell_halo",
             "gmres_none_allgather", "ir_cg_ilu0", "cg_saamg", "cg_rsamg", "cg_amg"]
_jax_results = {}


def jax_solve(case):
    if case not in _jax_results:
        import jax
        import jax.numpy as jnp
        import lssp_tpu as J
        from lssp_tpu.parallel import dist_solve as jsolve
        assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
        spec = {**BITWISE, **AMG}[case]
        S = MATRICES[spec["name"]]().to_scipy()
        A = J.sparse.CSR.from_scipy(S)
        opts = (J.SolverOptions(maxit=3000) if spec["rtol"] is None
                else J.SolverOptions(rtol=spec["rtol"], atol=0))
        x, info = getattr(jsolve, spec["entry"])(
            A, jnp.ones(S.shape[0]), method=spec["method"], pc=spec["pc"], fmt=spec["fmt"],
            mesh=jsolve.make_mesh(8), options=opts,
            pc_options=J.PCOptions(ilu_sweeps=spec["sweeps"], **spec["pco"]))
        _jax_results[case] = (np.asarray(x), int(info.nits), bool(info.converged))
    return _jax_results[case]


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", JAX_CASES)
def test_ranks_against_jax_mesh8(runs, world, case):
    per_rank, _ = ranks_and_ref(runs, world, case)
    xj, nj, cj = jax_solve(case)
    got = per_rank[0]
    assert cj and bool(got["converged"])
    assert abs(int(got["nits"]) - nj) <= 2
    assert np.linalg.norm(got["x"].numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


# ---------------------------------------------------------------------------
# in the parent alone: the stacked exact schedules, the block solvers' reduce=
# ---------------------------------------------------------------------------

def shard_factors(name, level):
    A = MATRICES[name]()
    R = A.shape[0] // NSHARDS
    blocks = [tsolve._extract_diag_block(A, p * R, (p + 1) * R) for p in range(NSHARDS)]
    return [T.pc.ilu_host.iluk_factor(blk, level=level) for blk in blocks], R


@pytest.mark.parametrize("factor", ["L", "U", "Ut", "Lt"])
@pytest.mark.parametrize("name,level", [("lap2", 0), ("convdiff", 1)])
def test_stack_schedules_match_jax(name, level, factor):
    """The port's ``_stack_schedules`` of the port's per-shard schedules has
    the arrays of JAX's ``_stack_schedules`` of JAX's, on the same factors."""
    import lssp_tpu as J
    from lssp_tpu.ops import trisolve as jtri
    from lssp_tpu.parallel import dist_solve as jsolve
    from lssp_tpu_torch.ops import trisolve as ttri
    factors, R = shard_factors(name, level)

    def scheds(tri, csr):
        out = []
        for L, U in factors:
            Lc, Uc = (csr(F.indptr, F.indices, F.data, F.shape) for F in (L, U))
            out.append({"L": lambda: tri.level_schedule(Lc, lower=True),
                        "U": lambda: tri.level_schedule(Uc, lower=False),
                        "Ut": lambda: tri.ilu_transpose_schedules(Lc, Uc)[0],
                        "Lt": lambda: tri.ilu_transpose_schedules(Lc, Uc)[1]}[factor]())
        return out
    mine = tsolve._stack_schedules(scheds(ttri, T.CSR), R)
    ref = jsolve._stack_schedules(scheds(jtri, J.sparse.CSR), R)
    for got, want in zip((mine.rows, mine.cols, mine.vals, mine.invdiag), ref):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,pc", [("lap2", "ilu0"), ("convdiff", "bjilu")])
def test_exact_ilu_state_is_stacked(name, pc):
    """The exact per-shard schedules are stacked while the stacked layout
    holds at most twice the factors' strict nnz (ROADMAP C 14's rule), and
    the stacked apply equals the per-shard list's to rounding."""
    from lssp_tpu_torch.ops.trisolve import ilu_apply, ilu_apply_t
    A = MATRICES[name]()
    R = A.shape[0] // NSHARDS
    opts = T.PCOptions(ilu_sweeps=0, transpose=True).resolved()
    kind, state = tsolve._build_dist_pc(A, pc, opts, NSHARDS, R, torch.device("cpu"))
    assert kind == "ilu" and len(state) == 4
    assert all(isinstance(S, tsolve.StackedSchedule) for S in state)
    # the per-shard list, as the apply ran it before the schedules were stacked
    per_shard = []
    for blk in (tsolve._extract_diag_block(A, p * R, (p + 1) * R) for p in range(NSHARDS)):
        L, U = T.pc.ilu_host.iluk_factor(blk, level=0 if pc == "ilu0" else opts.iluk_level)
        per_shard.append((T.ops.trisolve.level_schedule(L, lower=True),
                          T.ops.trisolve.level_schedule(U, lower=False))
                         + T.ops.trisolve.ilu_transpose_schedules(L, U))
    apply = tsolve._shard_pc_apply(kind, state, NSHARDS, R)
    for k in (None, 3):
        r = rhs(A.shape[0], k, seed=7)
        r2 = r.view(NSHARDS, R, *r.shape[1:])
        ref = torch.stack([ilu_apply(sc[0], sc[1], r2[p]) for p, sc in enumerate(per_shard)])
        ref_t = torch.stack([ilu_apply_t(sc[2], sc[3], r2[p])
                             for p, sc in enumerate(per_shard)])
        np.testing.assert_allclose(apply(r).numpy(), ref.reshape(r.shape).numpy(), rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(apply.t(r).numpy(), ref_t.reshape(r.shape).numpy(),
                                   rtol=1e-13, atol=1e-13)


def test_stack_or_list_keeps_a_list_past_twice_the_nnz():
    factors, R = shard_factors("lap2", 0)
    scheds = [T.ops.trisolve.level_schedule(L, lower=True) for L, _ in factors]
    nnz = sum(T.sparse.utils.split_ldu(L)[0].nnz for L, _ in factors)
    assert isinstance(tsolve._stack_or_list(scheds, nnz, R), tsolve.StackedSchedule)
    slots = NSHARDS * max(s.slots for s in scheds)
    assert tsolve._stack_or_list(scheds, slots // 2 - 1, R) == scheds


def _amg_hierarchies():
    from lssp_tpu_torch.amg.setup import amg_setup
    from lssp_tpu_torch.parallel import build_dist_amg, build_dist_rs, build_dist_sa
    return {
        "saamg_grid": lambda: build_dist_sa(MATRICES["lap2"](), NSHARDS),
        "saamg_line": lambda: build_dist_sa(MATRICES["aniso36"](), NSHARDS, grid=False,
                                            smoother="line"),
        "rsamg": lambda: build_dist_rs(MATRICES["lap3"](), NSHARDS, coarse_size=32),
        "amg": lambda: build_dist_amg(amg_setup(MATRICES["lap2"]()), NSHARDS),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["saamg_grid", "saamg_line", "rsamg", "amg"])
def test_hierarchy_local_cuts_put_back_whole(name, world):
    """``DistSA.local`` / ``DistAMG.local`` over every rank of W put back
    together give the whole hierarchy, field by field: every per-shard
    tensor is the concatenation of the ranks' cuts, the coarse inverse and
    the line smoother's interface inverses are the whole ones on every
    rank, and each cut level holds the rank's shards."""
    from lssp_tpu_torch.utils.tree import array_leaves
    h = _amg_hierarchies()[name]()
    slots = NSHARDS // world
    cuts = [h.local(r * slots, (r + 1) * slots) for r in range(world)]
    whole = array_leaves(h)
    parts = [array_leaves(c) for c in cuts]
    kept = 0
    for i, t in enumerate(whole):
        got = [p[i] for p in parts]
        if all(g is t for g in got):
            kept += 1
            continue
        assert all(g.shape[0] == slots for g in got)
        assert torch.equal(torch.cat(got), t)
    line_levels = sum(getattr(lev, "tri", None) is not None for lev in h.levels)
    assert kept == 1 + line_levels
    assert (line_levels > 0) == (name == "saamg_line")
    for c in cuts:
        assert len(c.levels) == len(h.levels)
        for lev, full in zip(c.levels, h.levels):
            if hasattr(lev, "nshards"):
                assert lev.nshards == slots and lev.A.nshards == slots
                assert (lev.agg, lev.n_next, lev.lmax) == (full.agg, full.n_next, full.lmax)
            else:
                assert lev.a_cols.shape[0] == slots and lev.n_pad == full.n_pad


@pytest.mark.parametrize("world", (2, 4))
def test_idrs_shadow_space_per_rank(world):
    """IDR(s)'s shadow space on a rank (its n_loc rows, ``op.shards`` =
    P_loc) is the one-process draw's columns of that rank's rows."""
    from lssp_tpu_torch.solvers.idrs import shadow_space
    n, s = NSHARDS * 64, 4
    whole = shadow_space(s, n, torch.float64, "cpu", shards=NSHARDS)
    n_loc = n // world
    for rank in range(world):
        local = shadow_space(s, n_loc, torch.float64, "cpu", shards=NSHARDS // world)
        assert torch.equal(local, whole[:, rank * n_loc:(rank + 1) * n_loc])


@pytest.mark.parametrize("method", ["block_cg", "block_gmres"])
def test_block_solvers_reduce(method):
    """``reduce=None`` and the identity reduction give the same bits: the
    reduction only adds the sum over ranks (over ranks:
    ``test_solves_to_rounding``'s block cases)."""
    from lssp_tpu_torch.solvers import block_cg, block_gmres
    from threadpoolctl import threadpool_limits
    fn = {"block_cg": block_cg.block_cg, "block_gmres": block_gmres.block_gmres}[method]
    A = T.sparse.csr_to_dia(T.sparse.laplacian_2d(16), device="cpu")
    B = rhs(A.shape[0], 4, seed=8)
    opts = T.SolverOptions(rtol=1e-10, atol=0).resolved()
    # one BLAS thread: the small Grams and least squares gain nothing from
    # more, and a busy machine makes the threads' waits dominate
    with threadpool_limits(1):
        X0, i0 = fn(A, B, opts=opts)
        X1, i1 = fn(A, B, opts=opts, reduce=lambda g: g)
    assert torch.equal(X0, X1) and np.array_equal(i0.nits, i1.nits)
    assert bool(np.all(i0.converged))


if __name__ == "__main__" and len(sys.argv) == 6 and sys.argv[1] == "--worker":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
