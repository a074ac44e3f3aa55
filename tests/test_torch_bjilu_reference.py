"""The port's block-Jacobi ILU(0) CG over four gloo ranks against the plain
reference ``bench_port/reference_bjilu0.py`` (PyTorch, fp64, written from
the textbook), on cell 1's 3-D Poisson at 12³: one slab of three planes
(432 rows) a rank, as the cell ``poisson3d_204_ilu0_w4.dist`` lays 204³
over four cards.

- The factors, built in fp64 (``dist_solve``): each rank's Lₛ, D⁻¹Uₛ and
  1/d equal the reference's ILU(0) of its slab to 1e-14 of the largest
  entry: each entry is a few multiply-subtracts of O(1) values, so two
  orders of elimination part by a few ulp (2.2e-16 each); they read 0.
- The apply the solve runs, in fp32 (``dist_solve_ir``'s state, 6 Neumann
  sweeps through K4's plain version): within 1e-5 (in norm, relative) of
  the reference's fp64 apply: the factors rounded to fp32 (6e-8 each) and
  12 sweeps of 3-band products summed in fp32 read 6.9e-8; 1e-5 keeps a
  margin and is 400 times under an apply one sweep short (4.2e-3).
- The answer: ``dist_solve_ir``'s x meets relres ≤ 1e-8 by the reference's
  fp64 residual, and lies within κ(A)·(1e-8 + 1e-12) of the reference's
  exact block-Jacobi PCG x (solved to 1e-12): both residuals bound each
  one's error by κ times it, κ(A) = λmax/λmin of the 12³ stencil.
- The reference loads nothing of the program nor JAX.
"""
import ast
import datetime
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench_port import reference_bjilu0 as ref  # noqa: E402

N, WORLD, TIMEOUT = 12, 4, 120
RTOL = 1e-8


def rhs(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n))


def band_dense(T_, R):
    """The (P, R, R) dense blocks of a DistDIA's (P, nd, R) bands."""
    P = T_.data.shape[0]
    out = torch.zeros((P, R, R), dtype=T_.data.dtype)
    for d, off in enumerate(T_.offsets):
        i = torch.arange(max(0, -off), min(R, R - off))
        out[:, i, i + off] = T_.data[:, d, i]
    return out


def worker(rank, rendezvous, out_dir):
    torch.set_num_threads(1)
    multihost.initialize(rendezvous, WORLD, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT))
    import torch.distributed as dist
    try:
        mesh = multihost.global_mesh(slots=1)
        A = T.sparse.laplacian_3d(N)
        n = A.shape[0]
        opts = dict(method="cg", pc="ilu0", mesh=mesh, pc_options=T.PCOptions(ilu_sweeps=6),
                    options=T.SolverOptions(rtol=RTOL, atol=0))
        x, info = T.parallel.dist_solve_ir(A, rhs(n, 1), **opts)
        T.parallel.dist_solve(A, rhs(n, 1), **opts)
        by_dtype = {str(p["pc_state"].invdiag.dtype): p for p in A._dist_cache.values()}
        st64, st32 = by_dtype["torch.float64"]["pc_state"], by_dtype["torch.float32"]["pc_state"]
        R = n // WORLD
        from lssp_tpu_torch.parallel.dist_solve import _shard_pc_apply
        r = rhs(n, 2).to(torch.float32)[rank * R:(rank + 1) * R]
        z = _shard_pc_apply("ilu_nm", st32, 1, R)(r)
        torch.save({"x": x, "nits": int(info.nits), "L": band_dense(st64.L, R)[0],
                    "U": band_dense(st64.U, R)[0], "inv": st64.invdiag[0], "z": z},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from lssp_tpu_torch import native
    native.load()
    tmp = tmp_path_factory.mktemp("bjilu_ref")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    procs = []
    for r in range(WORLD):
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, "--worker", str(r),
                                        f"file://{tmp / 'rdv'}", str(tmp)],
                                       cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + TIMEOUT + 30
    while time.monotonic() < deadline:
        codes = [p.poll() for p, _ in procs]
        if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.1)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if any(p.returncode for p, _ in procs):
        pytest.fail("\n".join((tmp / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD)))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def dense():
    return torch.from_numpy(T.sparse.laplacian_3d(N).to_scipy().toarray())


def test_each_ranks_factors_are_the_references_ilu0_of_its_slab(ranks, dense):
    _, factors = ref.block_jacobi(dense, WORLD)
    for rank, got in enumerate(ranks):
        Ls, d, Us = ref.split(factors[rank])
        scale = float(factors[rank].abs().max())
        assert float((got["L"] - Ls).abs().max()) <= 1e-14 * scale
        assert float((got["U"] - Us).abs().max()) <= 1e-14 * scale
        assert float((got["inv"] - 1.0 / d).abs().max()) <= 1e-14 * float((1.0 / d).abs().max())


def test_the_sharded_fp32_apply_is_the_references_to_fp32_rounding(ranks, dense):
    n = dense.shape[0]
    apply, _ = ref.block_jacobi(dense, WORLD, sweeps=6)
    want = apply(rhs(n, 2).to(torch.float32).to(torch.float64))
    got = torch.cat([g["z"] for g in ranks]).to(torch.float64)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-5
    # one sweep fewer is far outside it: the comparison sees the sweeps
    fewer, _ = ref.block_jacobi(dense, WORLD, sweeps=5)
    off = fewer(rhs(n, 2).to(torch.float32).to(torch.float64))
    assert float(torch.linalg.vector_norm(off - want) / torch.linalg.vector_norm(want)) > 1e-3


def test_the_answer_meets_rtol_and_the_references_pcg(ranks, dense):
    n = dense.shape[0]
    b = rhs(n, 1)
    for g in ranks[1:]:
        assert torch.equal(g["x"], ranks[0]["x"]) and g["nits"] == ranks[0]["nits"]
    x = ranks[0]["x"]
    assert ref.relres(dense, b, x) <= RTOL
    apply, _ = ref.block_jacobi(dense, WORLD)
    x_ref, its = ref.pcg(dense, b, apply, rtol=1e-12)
    assert ref.relres(dense, b, x_ref) <= 1e-12 and its < 200
    lam = [6 - 6 * math.cos(math.pi / (N + 1)), 6 + 6 * math.cos(math.pi / (N + 1))]
    kappa = lam[1] / lam[0]
    err = float(torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(x_ref))
    assert err <= kappa * (RTOL + 1e-12)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(ROOT, "bench_port", "reference_bjilu0.py")
    assert set(_imports(path)) <= {"__future__", "torch"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.reference_bjilu0\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(p.stdout.split("[")[-1].strip("]\n").replace("'", "").split(", "))
    assert not loaded & {"lssp_tpu_torch", "lssp_tpu", "jax", "jaxlib"}


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "--worker":
    worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
