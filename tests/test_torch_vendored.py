"""The slice as a whole on the two vendored general matrices
(``benchmarks/matrices``): MatrixMarket input, the RCM reorder, and solves
on the HYB and DIA paths, against lssp_tpu on the CPU and against the
golden records of the C reference.

- ``read_matrix_market`` gives the JAX package's CSR arrays exactly.
- ``maybe_rcm`` picks the JAX package's permutation; ``reorder="rcm"``
  solves give JAX's x to 1e-10 (relative) in its iteration count ±1.
- The 8 ``TestVendoredParity`` cells (tests/test_solvers.py) run on the
  port with that test's limits: golden iterations +10 % + 2, the ratchet
  (recorded + max(2, 5 %)), and the true residual.
- ``solve_ir`` bicgstab+iluk on coupled3d_25 (HYB) with the ILU apply
  pinned exact (0 sweeps) and Neumann (6 sweeps): JAX's count ±1, x to
  1e-8 relative.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.sparse import reorder as Jr
import lssp_tpu_torch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATDIR = os.path.join(REPO, "benchmarks", "matrices")
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
NAMES = ["coupled3d_25", "convdiff_rot_128"]


def _read(name):
    path = os.path.join(MATDIR, name + ".mtx.gz")
    return J.sparse.read_matrix_market(path), T.sparse.read_matrix_market(path)


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("name", NAMES)
def test_read_matrix_market_identical(name):
    Aj, At = _read(name)
    _same_csr(Aj, At)


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_write_read_round_trip(tmp_path, suffix):
    rng = np.random.default_rng(0)
    S = sp.random(50, 50, density=0.1, random_state=3, format="csr")
    S.data = rng.standard_normal(S.nnz)
    A = T.CSR.from_scipy(S)
    path = str(tmp_path / ("m" + suffix))
    T.sparse.write_matrix_market(path, A, comment="round trip")
    _same_csr(A, T.sparse.read_matrix_market(path))
    _same_csr(A, J.sparse.read_matrix_market(path))


def _permuted_laplacian():
    L = J.sparse.laplacian_2d(32)
    p = np.random.default_rng(0).permutation(L.shape[0])
    return sp.csr_matrix(Jr.permute_symmetric(L, p).to_scipy())


REORDER_CASES = {
    "permuted_laplacian": _permuted_laplacian,
    "anisotropic_eps100": lambda: sp.csr_matrix(
        J.sparse.anisotropic_poisson_2d(32, epsilon=100.0).to_scipy()),
    "coupled3d_25": lambda: sp.csr_matrix(_read("coupled3d_25")[0].to_scipy()),
}
EXPECT_PERM = {"permuted_laplacian": True, "anisotropic_eps100": True, "coupled3d_25": False}


@pytest.mark.parametrize("case", list(REORDER_CASES))
def test_reorder_matches_jax(case):
    S = REORDER_CASES[case]()
    Aj, At = J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)
    Bj, pj = Jr.maybe_rcm(Aj)
    Bt, pt = T.sparse.maybe_rcm(At)
    assert (pt is not None) == EXPECT_PERM[case] == (pj is not None)
    if pt is not None:
        assert np.array_equal(pj, pt)
    _same_csr(Bj, Bt)
    assert np.array_equal(Jr.rcm_permutation(Aj), T.sparse.rcm_permutation(At))
    gj, gt = Jr.grid_transpose_perm(Aj), T.sparse.grid_transpose_perm(At)
    assert (gj is None) == (gt is None) and (gt is None or np.array_equal(gj, gt))
    for fn in ("bandwidth", "num_diagonals", "band_coverage"):
        assert getattr(Jr, fn)(Aj) == getattr(T.sparse, fn)(At), fn


def _rel_diff(x, xj):
    xj = np.asarray(xj)
    return np.linalg.norm(np.asarray(x) - xj) / np.linalg.norm(xj)


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_solve_rcm_matches_jax(method):
    S = _permuted_laplacian()
    Aj, At = J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)
    n = S.shape[0]
    b = np.random.default_rng(1).standard_normal(n)
    kw = dict(method=method, pc="ilu0", reorder="rcm")
    xj, ij = J.solve(Aj, jnp.asarray(b), options=J.SolverOptions(rtol=1e-10), **kw)
    xt, it = T.solve(At, torch.from_numpy(b), options=T.SolverOptions(rtol=1e-10), **kw)
    assert abs(it.nits - int(ij.nits)) <= 1
    assert _rel_diff(xt, xj) <= 1e-10
    assert np.linalg.norm(b - S @ xt.numpy()) <= 1e-7 * np.linalg.norm(b)
    # the permutation is cached with the prepared matrix, keyed by reorder
    assert At._prepared_cache[("prepared", "rcm", "cpu")][2] is not None


def test_solver_lifecycle_and_solve_ir_rcm_match_jax():
    S = _permuted_laplacian()
    Aj, At = J.sparse.CSR.from_scipy(S), T.CSR.from_scipy(S)
    n = S.shape[0]
    rng = np.random.default_rng(2)
    sj, st = J.Solver("bicgstab", "ilu0"), T.Solver("bicgstab", "ilu0", device="cpu")
    sj.set_rtol(1e-10), st.set_rtol(1e-10)
    sj.assemble(Aj, reorder="rcm")
    st.assemble(At, reorder="rcm")
    assert st.perm is not None
    for _ in range(2):                     # each new b is permuted in, x out
        b = rng.standard_normal(n)
        xj = sj.solve(jnp.asarray(b), jnp.zeros(n))
        xt = st.solve(torch.from_numpy(b), torch.zeros(n, dtype=torch.float64))
        assert abs(st.nits - sj.nits) <= 1
        assert _rel_diff(xt, xj) <= 1e-10
    o = dict(rtol=1e-10, atol=0.0, rbtol=0.0)
    xj, ij = J.solve_ir(Aj, jnp.ones(n), method="cg", pc="ilu0", reorder="rcm",
                        options=J.SolverOptions(**o), pc_options=J.PCOptions(ilu_sweeps=0))
    xt, it = T.solve_ir(At, torch.ones(n, dtype=torch.float64), method="cg", pc="ilu0",
                        reorder="rcm", options=T.SolverOptions(**o),
                        pc_options=T.PCOptions(ilu_sweeps=0))
    assert abs(it.nits - int(ij.nits)) <= 1 and it.converged
    assert _rel_diff(xt, xj) <= 1e-8


def _golden():
    with open(os.path.join(GOLDEN_DIR, "vendored.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(GOLDEN_DIR, "ratchet.json")) as f:
        ratchet = json.load(f)
    return {(r["matrix"], r["solver"], r["pc"]): r for r in recs}, ratchet


GOLDEN, RATCHET = _golden()


@pytest.mark.parametrize("matrix,method,pc", [
    (m, s, p) for m in NAMES[::-1] for s in ("gmres", "bicgstab") for p in ("iluk", "ilut")])
def test_vendored_parity(matrix, method, pc):
    """TestVendoredParity on the port: the CPU default (exact ILU apply),
    b = 1, the golden record's restart and maxit, default tolerances."""
    rec = GOLDEN[(matrix, method, pc)]
    A = T.sparse.read_matrix_market(os.path.join(MATDIR, matrix + ".mtx.gz"))
    n = A.shape[0]
    x, info = T.solve(A, torch.ones(n, dtype=torch.float64), method=method, pc=pc,
                      options=T.SolverOptions(restart=rec["restart"], maxit=rec["maxit"]))
    true_res = float(np.linalg.norm(np.ones(n) - A.to_scipy() @ x.numpy()))
    assert info.converged
    assert true_res <= max(2.0 * rec["true_residual"], 1.1e-7 * np.sqrt(n) * 4)
    hi = int(np.ceil(rec["nits"] * 1.10)) + 2
    assert info.nits <= hi
    key = f"{method}+{pc}@{matrix}"
    lim = RATCHET[key] + max(2, int(np.ceil(0.05 * RATCHET[key])))
    assert info.nits <= lim, f"{key}: {info.nits} > ratchet limit {lim}"


@pytest.mark.parametrize("sweeps", [0, 6])
def test_solve_ir_coupled3d_matches_jax(sweeps):
    Aj, At = _read("coupled3d_25")
    n = At.shape[0]
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=5000)
    xj, ij = J.solve_ir(Aj, jnp.ones(n), method="bicgstab", pc="iluk",
                        options=J.SolverOptions(**o), pc_options=J.PCOptions(ilu_sweeps=sweeps))
    popts = T.PCOptions(ilu_sweeps=sweeps)
    xt, it = T.solve_ir(At, torch.ones(n, dtype=torch.float64), method="bicgstab", pc="iluk",
                        options=T.SolverOptions(**o), pc_options=popts)
    assert abs(it.nits - int(ij.nits)) <= 1 and it.converged
    assert _rel_diff(xt, xj) <= 1e-8
    assert np.linalg.norm(1 - At.to_scipy() @ xt.numpy()) <= 1e-8 * np.sqrt(n)
    _, A64, A32, perm, M32 = T.prepare_ir(At, method="bicgstab", pc="iluk", pc_options=popts,
                                          device="cpu")
    assert isinstance(A64, T.HYB) and isinstance(A32, T.HYB) and perm is None
    assert A32.dtype == torch.float32 and A32.rem_rows.dtype == torch.int32
    if sweeps:                 # the Neumann plan of the HYB matrix's factors has strays
        assert M32.state.L.stray_ptr is not None or M32.state.U.stray_ptr is not None
