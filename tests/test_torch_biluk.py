"""The block-ILU family of lssp_tpu_torch (biluk, bilut, vbiluk, vbilut, the
block level schedules) against lssp_tpu on the CPU.

Tolerances: host factors, block level schedules and the variable-block
embedding bitwise (the same numpy arithmetic); the exact and the Neumann
applies to 1e-13 relative to max|z| in fp64, an (n, k) block equal to its
columns' applies to 1e-13; the 38 ``+biluk`` ratchet keys (4×4 blocks,
n / 4 of them) at N=32 with ``test_torch_krylov_common.parity`` (counts
JAX's ±1, x to 1e-8 at the same number of iterations) and at N=100 by the
port alone, each held to recorded + max(2, 5 %); the acceptance config
``bicgstabl_biluk_elasticity`` by its TPU route (``solve_ir``, 6 sweeps)
JAX's count ±1 and 111 ± 1, by its CPU route (fp64 ``Solver``, exact)
JAX's count ±1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.ops import block_trisolve as jbt
from lssp_tpu.pc import biluk as jbiluk
import lssp_tpu_torch as T
from lssp_tpu_torch.ops import block_trisolve as tbt
from lssp_tpu_torch.pc import biluk as tbiluk
from test_torch_krylov_common import parity, ratchet_100

CASES = [("laplacian_2d", 16, 4), ("elasticity_2d", 10, 2), ("convection_diffusion_2d", 12, 3)]
IDS = [f"{g}({N})-bs{bs}" for g, N, bs in CASES]


def _pair(gen, N, bs):
    return (J.sparse.csr_to_bsr(getattr(J.sparse, gen)(N), bs),
            T.sparse.csr_to_bsr(getattr(T.sparse, gen)(N), bs))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _same_factors(ft, fj):
    (lp, lc, lb), inv, (up, uc, ub) = ft
    (jlp, jlc, jlb), jinv, (jup, juc, jub) = fj
    for a, b in ((lp, jlp), (lc, jlc), (lb, jlb), (inv, jinv), (up, jup), (uc, juc),
                 (ub, jub)):
        assert _same(a, b)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("gen,N,bs", CASES, ids=IDS)
def test_biluk_factors_bitwise(gen, N, bs, level):
    Bj, Bt = _pair(gen, N, bs)
    _same_factors(tbiluk.biluk_factor_bsr(Bt, level=level),
                  jbiluk.biluk_factor_bsr(Bj, level=level, raw=True))


@pytest.mark.parametrize("tol,p", [(1e-3, -1), (1e-2, 2)])
@pytest.mark.parametrize("gen,N,bs", CASES, ids=IDS)
def test_bilut_factors_bitwise(gen, N, bs, tol, p):
    Bj, Bt = _pair(gen, N, bs)
    _same_factors(tbiluk.bilut_factor_bsr(Bt, tol=tol, p=p),
                  jbiluk.bilut_factor_bsr(Bj, tol=tol, p=p, raw=True))


@pytest.mark.parametrize("gen,N,bs", CASES, ids=IDS)
def test_block_level_schedules_bitwise(gen, N, bs):
    Bj, Bt = _pair(gen, N, bs)
    (lp, lc, lb), _, (up, uc, ub) = tbiluk.biluk_factor_bsr(Bt, level=1)
    for args, lower in (((lp, lc, lb), True), ((up, uc, ub), False)):
        sj = jbt.block_level_schedule(*args, Bt.nrowb, bs, lower=lower)
        st = tbt.block_level_schedule(*args, Bt.nrowb, bs, lower=lower)
        assert np.array_equal(st.rows.numpy(), np.asarray(sj.rows))
        assert np.array_equal(st.cols.numpy(), np.asarray(sj.cols))
        assert _same(st.vals.numpy(), sj.vals)


def test_variable_block_embedding_bitwise():
    A = T.sparse.convection_diffusion_2d(9)              # n = 81
    Aj = J.sparse.convection_diffusion_2d(9)
    sizes = [3, 2, 4, 1] * 8 + [1]
    Et, bst, npt, embt = tbiluk.vb_embed_matrix(A, sizes)
    Ej, bsj, npj, embj = jbiluk._vb_embed_matrix(Aj, sizes)
    assert (bst, npt) == (bsj, npj) and _same(embt, embj)
    for f in ("indptr", "indices", "data"):
        assert _same(getattr(Et, f), getattr(Ej, f))


def _pcs(pc, A_j, A_t, **kw):
    Mj = J.pc.setup(A_j, pc, J.PCOptions(**kw))
    Mt = T.pc.setup(A_t, pc, T.PCOptions(**kw), device="cpu")
    return Mj, Mt


PCS = [("biluk", dict(block_size=2)), ("biluk", dict(num_blocks=50, iluk_level=2)),
       ("bilut", dict(block_size=4)), ("vbiluk", dict(block_sizes=[2, 3, 5] * 9 + [2, 2, 2, 4])),
       ("vbilut", dict(block_sizes=[4] * 25))]


@pytest.mark.parametrize("sweeps", [0, 6, -1])
@pytest.mark.parametrize("pc,kw", PCS, ids=[f"{p}-{i}" for i, (p, _) in enumerate(PCS)])
def test_applies_match_jax(pc, kw, sweeps):
    """The exact (sweeps 0), Neumann (6) and complete-series (-1) applies on
    an unsymmetric 100-row system, and the k-rhs apply column by column."""
    Aj, At = J.sparse.convection_diffusion_2d(10), T.sparse.convection_diffusion_2d(10)
    Mj, Mt = _pcs(pc, Aj, At, ilu_sweeps=sweeps, **kw)
    assert Mt.name == Mj.name
    R = np.random.default_rng(11).standard_normal((100, 3))
    zt = Mt(torch.from_numpy(R)).numpy()
    for c in range(3):
        zj = np.asarray(Mj(jnp.asarray(R[:, c])))
        assert _rel(Mt(torch.from_numpy(R[:, c])).numpy(), zj) <= 1e-13
        assert _rel(zt[:, c], zj) <= 1e-13


def test_neumann_route_needs_block_bands():
    """Block-banded factors take the BDIA Neumann apply; a non-banded
    pattern falls back to the exact schedules, as JAX's ``_pack_bilu_pc``."""
    import scipy.sparse as sp
    At = T.sparse.elasticity_2d(8)
    M = T.pc.setup(At, "biluk", T.PCOptions(block_size=2, ilu_sweeps=6), device="cpu")
    assert M.name.endswith("-n6") and type(M.state[0]).__name__ == "BDIA"
    R = sp.random(128, 128, density=0.1, random_state=5, format="csr") + 8 * sp.eye(128)
    Rt = T.sparse.CSR.from_scipy(R.tocsr())
    Rj = J.sparse.CSR.from_scipy(R.tocsr())
    Mj, Mt = _pcs("biluk", Rj, Rt, block_size=2, ilu_sweeps=6)
    assert Mt.name == Mj.name == "biluk(1)"
    r = np.random.default_rng(1).standard_normal(128)
    assert _rel(Mt(torch.from_numpy(r)).numpy(), np.asarray(Mj(jnp.asarray(r)))) <= 1e-13


def test_missing_block_options_raise():
    A = T.sparse.laplacian_2d(4)
    for pc in ("biluk", "bilut"):
        with pytest.raises(ValueError, match="num_blocks"):
            T.pc.setup(A, pc, T.PCOptions(), device="cpu")
    for pc in ("vbiluk", "vbilut"):
        with pytest.raises(ValueError, match="block_sizes"):
            T.pc.setup(A, pc, T.PCOptions(), device="cpu")


RATCHET_METHODS = ["bicgsafe", "bicgstab", "bicgstabl", "bicrsafe", "bicrstab", "cg", "cgs",
                   "cr", "crs", "gmres", "gpbicg", "gpbicr", "idrs", "lgmres", "orthomin",
                   "qmrcgstab", "rgmres", "rlgmres", "tfqmr"]


@pytest.mark.parametrize("method", RATCHET_METHODS, ids=[f"{m}+biluk" for m in RATCHET_METHODS])
def test_ratchet_32_matches_jax(method):
    parity(method, "biluk")


@pytest.mark.parametrize("method", RATCHET_METHODS,
                         ids=[f"{m}+biluk@100" for m in RATCHET_METHODS])
def test_ratchet_100(method):
    ratchet_100(method, "biluk")


def test_acceptance_bicgstabl_biluk_elasticity():
    """``bicgstabl_biluk_elasticity`` (``benchmarks/acceptance.py:111-113``,
    ``elasticity_2d(48)``, rtol 1e-8): its recorded 111 is the TPU route,
    ``solve_ir`` with 6 Neumann sweeps (``benchmarks/results_r05.json``),
    held here to JAX's CPU count ±1 and to 111 ± 1; the CPU route,
    ``Solver`` in fp64 with the exact block schedules, to JAX's count ±1."""
    counts = {}
    for M, b in ((J, jnp.ones(2 * 48 * 48)), (T, torch.ones(2 * 48 * 48, dtype=torch.float64))):
        A = M.sparse.elasticity_2d(48)
        dev = {"device": "cpu"} if M is T else {}
        o = M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        x, info = M.solve_ir(A, b, method="bicgstabl", pc="biluk", options=o,
                             pc_options=M.PCOptions(block_size=2, ilu_sweeps=6), **dev)
        assert bool(info.converged)
        assert np.linalg.norm(1.0 - A.to_scipy() @ np.asarray(x)) <= 1e-8 * np.sqrt(A.shape[0])
        s = M.Solver(method="bicgstabl", pc="biluk", options=o,
                     pc_options=M.PCOptions(block_size=2, ilu_sweeps=0), **dev)
        s.assemble(A, b)
        x = np.asarray(s.solve())
        assert bool(s.info.converged)
        assert np.linalg.norm(1.0 - A.to_scipy() @ x) <= 1e-8 * np.sqrt(A.shape[0])
        counts[M.__name__] = (int(info.nits), int(s.info.nits))
    (ir_j, ex_j), (ir_t, ex_t) = counts["lssp_tpu"], counts["lssp_tpu_torch"]
    assert abs(ir_t - ir_j) <= 1 and abs(ir_t - 111) <= 1 and abs(ex_t - ex_j) <= 1, counts


BLOCK_PCS = [("biluk", dict(block_size=2)), ("bilut", dict(block_size=2)),
             ("vbiluk", dict(block_sizes=[2] * 144)), ("vbilut", dict(block_sizes=[4] * 72))]


@pytest.mark.parametrize("pc,kw", BLOCK_PCS, ids=[p for p, _ in BLOCK_PCS])
def test_solve_on_bsr_with_each_block_pc(pc, kw):
    """``solve`` on a ``BSR`` (the elasticity 12², 2×2 blocks) with each of the
    four block-ILU names, exact applies: JAX's count ±1 and x to 1e-8."""
    Bj = J.sparse.csr_to_bsr(J.sparse.elasticity_2d(12), 2)
    Bt = T.sparse.csr_to_bsr(T.sparse.elasticity_2d(12), 2)
    o = dict(maxit=2000, restart=60)
    xj, ij = J.solve(Bj, jnp.ones(288), method="gmres", pc=pc, options=J.SolverOptions(**o),
                     pc_options=J.PCOptions(ilu_sweeps=0, **kw))
    xt, it = T.solve(Bt, torch.ones(288, dtype=torch.float64), method="gmres", pc=pc,
                     options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=0, **kw),
                     device="cpu")
    assert it.converged and bool(ij.converged) and abs(it.nits - int(ij.nits)) <= 1
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)
