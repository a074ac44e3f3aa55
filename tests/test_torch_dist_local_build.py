"""The rank-local build of block-Jacobi ILU over gloo ranks on the CPU.

Each rank of W = 2 and 4 factors, bands, partitions and uploads only its
own shards (``dist_solve._build_dist_own``), with the choices every shard
shares taken from one all-gather of their statistics.  Held here, case by
case (cell 1's 3-D Poisson at 12³ and 16³, with slabs of whole planes and
without; a random graph Laplacian, on exact level schedules and on the
per-shard offset sets of ``ilu_nmd``; ILU(0), ILU(1) and ILUT):

- each rank's state (the partitioned matrix in both precisions and the
  preconditioner's state) is bitwise the whole build's cut to its shards:
  every block factored, the whole matrix partitioned, ``_local_state``;
- ``builds["rows_factored"]`` counts the rank's rows alone;
- ``dist_solve_ir``'s x and iteration count are bitwise the one-process
  mesh's of as many shards, on every rank; on exact level schedules, whose
  stacked sweeps round by their stack's shape, x to 1e-10 relative and
  the count ±1, as ``tests/test_torch_dist_ranks.py`` holds them;
- a change to one rank's rows makes every rank's memo go stale on the same
  call, so that no rank builds alone into the build's collective.

Workers run this file as a script (``--worker``), one thread each, with a
``file://`` rendezvous and a 120 s group timeout; the parent kills them
after as long, so a hang fails the tests.
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
import torch

import lssp_tpu_torch as T
from lssp_tpu_torch import _kernels
from lssp_tpu_torch.parallel import multihost
from lssp_tpu_torch.parallel.partition import partition_matrix
from lssp_tpu_torch.pc.base import rounding_to
from lssp_tpu_torch.sparse.types import round_to
from lssp_tpu_torch.utils import memo

# the module (``lssp_tpu_torch.parallel`` re-exports a function of its name)
tsolve = importlib.import_module("lssp_tpu_torch.parallel.dist_solve")

WORLDS = (2, 4)
TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def graph_laplacian(n=512, seed=4):
    """A random graph Laplacian plus a shift: no band, no grid."""
    R = sp.random(n, n, density=0.01, random_state=seed)
    W = -(abs(R) + abs(R.T))
    W = W - sp.diags(W.diagonal())
    return T.CSR.from_scipy((W + sp.diags(-np.asarray(W.sum(axis=1)).ravel() + 0.05)).tocsr())


def patchy(n=1024, shards=8, seed=5):
    """A symmetric diagonally dominant matrix whose every shard couples
    its rows at 40 offsets of its own: each shard's factor is narrow, the
    union of the shards' offsets is not (``ilu_nmd``)."""
    rng = np.random.default_rng(seed)
    R = n // shards
    rows, cols = [], []
    for p in range(shards):
        for off in rng.choice(np.arange(1, R), 40, replace=False):
            r = np.arange(p * R, (p + 1) * R - off)
            rows += [r, r + off]
            cols += [r + off, r]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    S = sp.coo_matrix((-np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    S = S + sp.diags(1.0 + np.asarray(abs(S).sum(axis=1)).ravel())
    return T.CSR.from_scipy(S.tocsr())


MATRICES = {
    "lap3_12": lambda: T.sparse.laplacian_3d(12),
    "lap3_16": lambda: T.sparse.laplacian_3d(16),
    "graph": graph_laplacian,
    "patchy": patchy,
}

# (matrix, entry, method, pc, ilu_sweeps, iluk_level, global shards or None
# for one a rank, the kind of state it must take)
CASES = {
    # 12³ over W: slabs of whole planes (W = 2: 6 planes, W = 4: 3)
    "lap12_ilu0": ("lap3_12", "dist_solve_ir", "cg", "ilu0", 6, 1, None, "ilu_nm"),
    # 12³ over 8 shards: 216 rows, a plane and a half a shard
    "lap12_ilu0_half_planes": ("lap3_12", "dist_solve_ir", "cg", "ilu0", 6, 1, 8, "ilu_nm"),
    "lap12_iluk1": ("lap3_12", "dist_solve_ir", "cg", "iluk", 6, 1, 8, "ilu_nm"),
    "lap16_ilu0": ("lap3_16", "dist_solve_ir", "cg", "ilu0", 6, 1, None, "ilu_nm"),
    # 16³ over 12 shards: 8 identity rows padded on
    "lap16_ilut_padded": ("lap3_16", "dist_solve_ir", "cg", "ilut", 6, 1, 12, "ilu_nm"),
    "lap16_ilu0_exact_depth": ("lap3_16", "dist_solve", "cg", "ilu0", -1, 1, 8, "ilu_nm"),
    "graph_exact": ("graph", "dist_solve_ir", "cg", "ilu0", 0, 1, 8, "ilu"),
    # every shard's factor past the streaming cap: the exact fallback
    "graph_fallback": ("graph", "dist_solve_ir", "gmres", "ilut", 6, 1, 4, "ilu"),
    "patchy_nmd": ("patchy", "dist_solve_ir", "cg", "ilu0", 6, 1, 8, "ilu_nmd"),
}
# the solves whose x is held to rounding: exact level schedules
ROUNDED = {"graph_exact", "graph_fallback"}


def mesh_of(case, world):
    """(global shards, slots a rank) of a case on W ranks."""
    P = CASES[case][6] or world
    return P, P // world


def options(case):
    _, _, _, pc, sweeps, level, _, _ = CASES[case]
    return T.PCOptions(ilu_sweeps=sweeps, iluk_level=level)


def same(a, b, where=""):
    """The places where ``a`` and ``b`` differ: tensors by dtype, shape and
    bits, dataclasses, tuples, lists and dicts field by field, anything
    else by ``==``."""
    import dataclasses
    if isinstance(a, torch.Tensor):
        ok = (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b))
        return [] if ok else [where]
    if type(a) is not type(b):
        return [f"{where}: {type(a).__name__} != {type(b).__name__}"]
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a)
                for d in same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")]
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return [f"{where}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in same(x, y, f"{where}[{i}]")]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{where}: keys"]
        return [d for k in a for d in same(a[k], b[k], f"{where}[{k}]")]
    return [] if a == b else [f"{where}: {a!r} != {b!r}"]


def whole_cut(A, mesh, pc, pc_opts, ir, dtype):
    """The whole build, every block factored and the whole matrix
    partitioned, cut to this rank's shards: what each rank built before
    the build became the rank's own."""
    pc_opts = pc_opts.resolved()
    Pn = mesh.size
    A = tsolve._grow_identity(A, (-A.shape[0]) % Pn)
    n = A.shape[0]
    R = n // Pn
    wdtype = torch.float32 if ir else dtype
    work = round_to(A, wdtype)
    with rounding_to(wdtype):
        kind, st = tsolve._build_dist_pc(work, pc, pc_opts, Pn, R, torch.device("cpu"))
    p0, p1 = mesh.rank * mesh.slots, (mesh.rank + 1) * mesh.slots
    M = partition_matrix(work, Pn).local(p0, p1).to("cpu", dtype=wdtype)
    M64 = partition_matrix(A.astype(np.float64), Pn).local(p0, p1).to("cpu") if ir else None
    return dict(n=n, R=R, M=M, M64=M64, kind=kind, pc_state=tsolve._local_state(kind, st, p0, p1))


def solve(case, mesh):
    name, entry, method, pc, _, _, _, _ = CASES[case]
    A = MATRICES[name]()
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(A.shape[0]))
    rows = tsolve.builds["rows_factored"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x, info = getattr(T.parallel, entry)(A, b, method=method, pc=pc, mesh=mesh,
                                             options=T.SolverOptions(rtol=1e-10, atol=0),
                                             pc_options=options(case))
    return A, x, info, tsolve.builds["rows_factored"] - rows


def build_case(case):
    def run(mesh):
        A, x, info, factored = solve(case, mesh)
        (prep,) = A._dist_cache.values()
        ir = CASES[case][1] == "dist_solve_ir"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = whole_cut(MATRICES[CASES[case][0]](), mesh, CASES[case][3],
                            options(case).resolved(), ir, torch.float64)
        # default_ilu_sweeps resolves None only; every case names its sweeps
        return {"x": x, "nits": torch.tensor(int(info.nits)),
                "converged": torch.tensor(bool(info.converged)),
                "mismatch": same(prep, ref), "kind": prep["kind"],
                "rows_factored": factored, "R": prep["R"]}
    return run


def stale_case(mesh):
    """Solve, change values in the last rank's rows of every rank's copy of
    A, solve again: every rank's lookup goes stale on the second call and
    every rank builds again (the build's all-gather meets on every rank)."""
    A = T.sparse.laplacian_3d(8)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="cg", pc="ilu0", mesh=mesh, options=T.SolverOptions(rtol=1e-10, atol=0),
              pc_options=T.PCOptions(ilu_sweeps=6))
    T.parallel.dist_solve_ir(A, b, **kw)
    before = (memo.lookups["stale"], tsolve.builds["count"])
    A.data[-1] += 0.5                  # the last row's diagonal: the last rank's row
    x, info = T.parallel.dist_solve_ir(A, b, **kw)
    relres = float((b - torch.from_numpy(A.to_scipy() @ x.numpy())).norm() / b.norm())
    return {"stale": memo.lookups["stale"] - before[0], "built": tsolve.builds["count"] - before[1],
            "relres": relres, "host_ranks": memo.host_ranks}


def run_cases(world, mesh_for):
    out = {c: build_case(c)(mesh_for(c)) for c in CASES}
    out["stale"] = stale_case(mesh_for(None))
    return out


def worker(world, rank, rendezvous, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(rendezvous, world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT))
    import torch.distributed as dist
    try:
        def mesh_for(case):
            slots = mesh_of(case, world)[1] if case else 1
            return multihost.global_mesh(slots=slots)
        torch.save(run_cases(world, mesh_for), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp):
    out = tmp / f"w{world}"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    env.pop("LOCAL_WORLD_SIZE", None)
    procs = []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, "--worker", str(world), str(r),
                                        f"file://{tmp / f'rdv{world}'}", str(out)],
                                       cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    return out, procs


def _collect(world, out, procs, deadline):
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
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({W: [each rank's results]}, {W: the one-process mesh's solves})."""
    from lssp_tpu_torch import native
    native.load()
    tmp = tmp_path_factory.mktemp("local_build")
    spawned = {w: _spawn(w, tmp) for w in WORLDS}
    deadline = time.monotonic() + TIMEOUT + 30
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for w in WORLDS:
            ref[w] = {}
            for c in CASES:
                _, x, info, _ = solve(c, T.make_mesh(devices=["cpu"] * mesh_of(c, w)[0]))
                ref[w][c] = (x, int(info.nits))
    finally:
        torch.set_num_threads(threads)
    got, errors = {}, []
    for w, (out, procs) in spawned.items():
        try:
            got[w] = _collect(w, out, procs, deadline)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        pytest.fail("\n".join(errors))
    return got, ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_builds_the_whole_builds_cut(runs, world, case):
    for r, res in enumerate(runs[0][world]):
        g = res[case]
        assert g["mismatch"] == [], (r, g["mismatch"][:5])
        assert g["kind"] == CASES[case][7]
        assert g["rows_factored"] == mesh_of(case, world)[1] * g["R"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_the_answer_is_the_one_process_meshs(runs, world, case):
    per_rank = [res[case] for res in runs[0][world]]
    x_ref, nits_ref = runs[1][world][case]
    for g in per_rank:
        assert bool(g["converged"])
        assert torch.equal(g["x"], per_rank[0]["x"]) and torch.equal(g["nits"],
                                                                     per_rank[0]["nits"])
    got = per_rank[0]
    if case in ROUNDED:
        assert abs(int(got["nits"]) - nits_ref) <= 1
        assert float((got["x"] - x_ref).norm() / x_ref.norm()) <= 1e-10
    else:
        assert torch.equal(got["x"], x_ref) and int(got["nits"]) == nits_ref


@pytest.mark.parametrize("world", WORLDS)
def test_a_change_to_one_ranks_rows_rebuilds_every_rank(runs, world):
    for res in runs[0][world]:
        s = res["stale"]
        assert (s["stale"], s["built"]) == (1, 1)
        assert s["relres"] <= 1e-9
        assert s["host_ranks"] == world       # every rank on this one host


@pytest.mark.parametrize("local,threads", [("1", 16), ("4", 4), (None, 4)])
def test_the_folds_threads_are_shared_by_the_hosts_ranks(monkeypatch, local, threads):
    """32 cores: one rank folds on 16 threads, four ranks on 4 each, from
    torchrun's LOCAL_WORLD_SIZE or, without it, the ranks
    ``multihost.initialize`` counted on the host; a small buffer on one."""
    monkeypatch.setattr(memo, "_cores", lambda: 32)
    monkeypatch.setattr(memo, "host_ranks", 4)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert memo._split_threads(memo.SPLIT_MIN_BYTES) == threads
    assert memo._split_threads(memo.SPLIT_MIN_BYTES - 1) == 1


@pytest.mark.parametrize("name", ["lap3_12", "graph", "far"])
def test_shard_stats_count_every_offset(name):
    """Each shard's offsets and counts are ``np.unique``'s of its entries'
    col − row, by the counting pass on a band (the Poisson) and by the
    sort where the offsets spread wide (a coupling of the first and last
    rows)."""
    from lssp_tpu_torch.parallel.partition import shard_stats
    P = 4
    if name == "far":
        S = sp.eye(1024, format="lil") * 4.0
        S[0, 1023] = S[1023, 0] = -1.0
        A, P = T.CSR.from_scipy(S.tocsr()), 16
    else:
        A = MATRICES[name]()
    R = A.shape[0] // P
    ip = np.asarray(A.indptr).astype(np.int64)
    d = np.asarray(A.indices) - np.repeat(np.arange(A.shape[0]), np.diff(ip))
    for p, st in enumerate(shard_stats(A, R, 0, P)):
        want, counts = np.unique(d[ip[p * R]:ip[(p + 1) * R]], return_counts=True)
        np.testing.assert_array_equal(st.offsets, want)
        np.testing.assert_array_equal(st.counts, counts)
        np.testing.assert_array_equal(st.nonzero[0], counts)


def test_k4_launches_are_counted_by_shape_through_a_graphs_replays():
    """``_kernels.launched`` with a shape counts it in ``by_shape``; inside
    ``recording`` it is kept and counted once a replay."""
    counter = type("K4", (), {"launches": 0, "by_dtype": {}, "by_shape": {}})
    _kernels.launched(counter, "f32", shape=(7, 4, 4, 64, 1, 4))
    with _kernels.recording() as recorded:
        _kernels.launched(counter, "f32", shape=(3, 4, 0, 64, 1, 4))
        _kernels.launched(counter, "f64", shape=(7, 4, 4, 64, 1, 8))
    for _ in range(3):
        _kernels.replayed(recorded)
    assert counter.launches == 7
    assert counter.by_shape == {(7, 4, 4, 64, 1, 4): 1, (3, 4, 0, 64, 1, 4): 3,
                                (7, 4, 4, 64, 1, 8): 3}


if __name__ == "__main__" and len(sys.argv) == 6 and sys.argv[1] == "--worker":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
