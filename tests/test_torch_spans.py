"""The program's spans (``utils/profile.annotate``) and the memo's lookup
counter on the CPU: each request opens its span, and inside it the
refinement rounds, the inner solves, the PC applies and the AMG levels
nest as the layers call each other; with no profiler recording a span
opens nothing; ``memo.lookups`` tells hits, misses and stale entries
apart."""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import multihost
from lssp_tpu_torch.utils import memo
from lssp_tpu_torch.utils import profile as prof_mod

OPTS = T.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, restart=30)


def spans(fn):
    """(fn's result, {name: [(start, end), ...]}) of the ``lssp.*`` ranges
    that one call of ``fn`` opens under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    got = {}
    for e in p.events():
        if e.name.startswith("lssp."):
            got.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out, got


def inside(inner, outer) -> bool:
    """Whether every range of ``inner`` lies within some range of ``outer``."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def system(pc):
    if pc == "ilu0":
        return T.sparse.laplacian_3d(8)
    return T.sparse.anisotropic_poisson_2d(32, epsilon=0.01)


def request(entry, method, pc, A, b):
    fn = getattr(T, entry)
    return lambda: fn(A, b, method=method, pc=pc, options=OPTS, device="cpu")


CASES = [("solve_ir", "cg", "ilu0"), ("solve_ir", "gmres", "saamg"),
         ("solve_ir_multi", "blockcg", "ilu0"), ("solve_ir", "cg", "rsamg"),
         ("solve_ir", "gmres", "amg")]


@pytest.mark.parametrize("entry,method,pc", CASES, ids=lambda v: v)
def test_a_request_nests_its_layers(entry, method, pc):
    A = system(pc)
    n = A.shape[0]
    b = (torch.from_numpy(np.random.default_rng(5).standard_normal((n, 3)))
         if entry.endswith("multi") else torch.ones(n, dtype=torch.float64))
    request(entry, method, pc, A, b)()                   # set-up memoized
    (x, info), got = spans(request(entry, method, pc, A, b))
    req = got[f"lssp.{entry}"]
    assert len(req) == 1
    assert len(got["lssp.memo.fingerprint"]) == 1 and inside(got["lssp.memo.fingerprint"], req)
    rounds, inner, apply = got["lssp.ir.round"], got["lssp.krylov.inner"], got["lssp.pc.apply"]
    assert len(inner) == len(rounds) >= 1
    assert inside(rounds, req) and inside(inner, rounds) and inside(apply, inner)
    assert len(apply) >= int(np.max(info.nits)) > 0
    levels = sorted(k for k in got if k.startswith("lssp.amg.level."))
    if pc == "ilu0":
        assert not levels
        return
    depth = [int(k.rsplit(".", 1)[1]) for k in levels]
    assert depth == list(range(len(depth))) and len(depth) >= 2
    assert inside(got["lssp.amg.level.0"], apply)
    for l in depth[1:]:
        # the deeper level runs inside the level above it
        assert inside(got[f"lssp.amg.level.{l}"], got[f"lssp.amg.level.{l - 1}"])


@pytest.mark.parametrize("entry", ["solve", "solve_multi"])
def test_the_one_shot_entries_open_their_span(entry):
    A = T.sparse.laplacian_2d(12)
    b = torch.ones((A.shape[0], 2) if entry.endswith("multi") else A.shape[0],
                   dtype=torch.float64)
    _, got = spans(request(entry, "cg", "jacobi", A, b))
    assert len(got[f"lssp.{entry}"]) == 1
    assert inside(got["lssp.pc.apply"], got[f"lssp.{entry}"])
    # a first call converts the matrix: the phase spans sit inside the request
    assert inside(got["lssp.memo.fingerprint"], got[f"lssp.{entry}"])


def test_phases_are_spans_under_their_own_names():
    A = T.sparse.laplacian_2d(16)
    prof_mod.reset_phases()
    _, got = spans(lambda: T.prepare_ir(A, method="cg", pc="saamg", device="cpu"))
    for name in prof_mod.phase_times():
        assert f"lssp.{name}" in got, name
    assert inside(got["lssp.saamg_host_levels"], got["lssp.pc_build"])


def raiser(*args, **kwargs):
    raise AssertionError("a span opened a range with no profiler recording")


def test_no_profiler_no_range(monkeypatch):
    monkeypatch.setattr(prof_mod, "_RecordFast", raiser)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", raiser)
    monkeypatch.setattr(torch.profiler, "record_function", raiser)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", raiser)
    assert prof_mod.annotate("lssp.a") is prof_mod.annotate("lssp.b")
    A = T.sparse.anisotropic_poisson_2d(16, epsilon=0.01)
    x, info = T.solve_ir(A, np.ones(A.shape[0]), method="gmres", pc="saamg", options=OPTS,
                         device="cpu")
    assert bool(info.converged)
    # the same patches do fire once a profiler records
    with pytest.raises(AssertionError, match="no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            with prof_mod.annotate("lssp.a"):
                pass


# each entry's memo lookups a call: solve and solve_multi the prepared
# matrix; the refinement entries prepare_ir's three (matrix, both
# precisions, PC); the mesh its distributed state, and saamg's sizing
LOOKUPS = [("solve", "ilu0", 1), ("solve_multi", "ilu0", 1), ("solve_ir", "ilu0", 3),
           ("solve_ir_multi", "ilu0", 3), ("dist_solve_ir", "ilu0", 1),
           ("dist_solve_ir", "saamg", 2)]


@pytest.mark.parametrize("entry,pc,k", LOOKUPS, ids=lambda v: str(v))
def test_memo_lookups_hit_miss_stale(tmp_path, entry, pc, k):
    A = T.sparse.laplacian_2d(12)
    A = type(A)(A.indptr.copy(), A.indices.copy(), A.data.copy(), A.shape)
    n = A.shape[0]
    b = torch.ones((n, 2) if entry.endswith("multi") else n, dtype=torch.float64)
    group = entry.startswith("dist")
    if group:
        multihost.initialize(f"file://{tmp_path / 'rdv'}", 1, 0, device="cpu",
                             timeout=datetime.timedelta(seconds=60))
        mesh = multihost.global_mesh(slots=2)

        def solve():
            return T.parallel.dist_solve_ir(A, b, method="cg", pc=pc, mesh=mesh, options=OPTS)
    else:
        solve = request(entry, "cg", pc, A, b)

    def counted():
        memo.lookups.clear()
        solve()
        return dict(memo.lookups)
    try:
        assert counted() == {"miss": k}
        assert counted() == {"hit": k}
        A.data[0] += 1.0                                  # the matrix changed in place
        assert counted() == {"stale": k}
        assert counted() == {"hit": k}
    finally:
        if group:
            dist.destroy_process_group()


@pytest.mark.parametrize("pc", ["jacobi", "saamg"])
def test_dist_solve_ir_over_a_group_of_one(tmp_path, pc):
    A = T.sparse.anisotropic_poisson_2d(16, epsilon=0.01)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    multihost.initialize(f"file://{tmp_path / 'rdv'}", 1, 0, device="cpu",
                         timeout=datetime.timedelta(seconds=60))
    try:
        mesh = multihost.global_mesh(slots=2)

        def solve():
            return T.parallel.dist_solve_ir(A, b, method="gmres", pc=pc, mesh=mesh,
                                            options=OPTS)
        solve()
        (x, info), got = spans(solve)
    finally:
        dist.destroy_process_group()
    assert bool(info.converged)
    req = got["lssp.dist_solve_ir"]
    assert len(req) == 1 and len(got["lssp.memo.fingerprint"]) == 1
    assert inside(got["lssp.ir.round"], req)
    assert inside(got["lssp.krylov.inner"], got["lssp.ir.round"])
    assert inside(got["lssp.pc.apply"], got["lssp.krylov.inner"])
    assert len(got["lssp.pc.apply"]) >= int(info.nits)
    # at world size 1 the dots still all-gather, as collectives of one
    assert inside(got["lssp.comm.all_gather"], req)
    if pc == "saamg":
        assert inside(got["lssp.amg.level.1"], got["lssp.amg.level.0"])
        assert inside(got["lssp.amg.level.0"], got["lssp.pc.apply"])


def test_dist_solve_without_a_group_opens_no_collective():
    A = T.sparse.laplacian_2d(16)
    mesh = T.make_mesh(2, devices=["cpu"] * 2)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    _, got = spans(lambda: T.parallel.dist_solve(A, b, method="cg", pc="jacobi", mesh=mesh,
                                                 options=OPTS))
    assert len(got["lssp.dist_solve"]) == 1
    assert inside(got["lssp.pc.apply"], got["lssp.dist_solve"])
    assert not any(k.startswith("lssp.comm.") for k in got)
