"""The multi-rhs path of lssp_tpu_torch against lssp_tpu on the CPU.

- The k-rhs plain versions (``dia_spmm_plain``, ``hyb_spmm_plain``,
  ``neumann_apply_plain`` on a block) against JAX's ``custom_vmap`` rules,
  reached as JAX's own tests reach them: ``jax.vmap`` over the Pallas
  wrappers run with ``interpret=True``.  Tolerance: max error over max
  |ref| ≤ 1e-12 in fp64, ≤ 1e-5 in fp32 (B5 is fp32 in JAX).
- Every block operand of the solve path equals the vector path column by
  column: the SpMV formats and mvops bit for bit on the CPU, the PCs to
  1e-13 (the level schedule sums in another order on a block).
- ``solve_multi`` per column (cg, gmres, rgmres, bicgstab): each column's
  count equals the port's single ``solve`` and JAX's ``solve_multi`` ±1,
  x within 1e-10.
- Block CG and block GMRES (tests/test_solvers_extra.py, AMG cases left
  out): true residual ≤ 1e-8 per column, counts within JAX's ±2.
- ``Solver.solve_multi`` and ``solve_ir_multi`` (tests/test_refine.py):
  true relres ≤ 1e-8 per column, counts against JAX's.
ILU sweeps are pinned (``ilu_sweeps=0``, exact) on both sides.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops import pallas_neumann as jpn
from lssp_tpu.ops import trisolve as jtri
from lssp_tpu.ops.pallas_spmv import dia_spmv_hyb_pallas, dia_spmv_hyb_tc_pallas, dia_spmv_pallas
from lssp_tpu.ops.spmv import lane_gather, spmv as jspmv
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
import lssp_tpu_torch as T
from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain
from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_block_apply,
                                        plan_fused_neumann)
from lssp_tpu_torch.ops import trisolve as ttri
from lssp_tpu_torch.pc.ilu_host import iluk_factor as t_iluk

spmv_mod = importlib.import_module("lssp_tpu_torch.ops.spmv")

EXACT = dict(j=J.PCOptions(ilu_sweeps=0), t=T.PCOptions(ilu_sweeps=0))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _block(n, k, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def nearly_banded(n_side=24, n_extra=60, seed=3, dtype=np.float64):
    """TestHYB._nearly_banded (tests/test_sparse.py), as scipy CSR."""
    rng = np.random.default_rng(seed)
    S = J.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] = S[i, j] + 0.01
    return S.tocsr().astype(dtype)


def _both(S):
    return J.sparse.CSR.from_scipy(S), T.sparse.CSR.from_scipy(S)


def _relres(A, B, X):
    B, X = np.asarray(B), np.asarray(X)
    return np.linalg.norm(B - A.to_scipy() @ X, axis=0) / np.linalg.norm(B, axis=0)


# ---------------------------------------------------------------- kernels' plain versions

@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_dia_spmm_plain_matches_pallas_vmap_rule(dtype, tol):
    """B1's k-rhs rule (``_vmap_safe_kernel``), with the scale epilogue."""
    Aj, At = J.sparse.laplacian_2d(20), T.sparse.laplacian_2d(20)
    Dj, Dt = J.sparse.csr_to_dia(Aj), T.sparse.csr_to_dia(At).to(dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    X = _block(400, 3, 0, dtype)
    Dj = dataclasses.replace(Dj, data=jnp.asarray(np.asarray(Dj.data), dtype))
    ref = np.asarray(jax.vmap(lambda v: dia_spmv_pallas(Dj, v, interpret=True, scale=0.5))(
        jnp.asarray(X.T))).T
    Y = dia_spmm_plain(Dt.data, Dt.offsets, torch.from_numpy(X), alpha=0.5)
    assert Y.shape == (400, 3) and Y.numpy().dtype == dtype
    assert _rel(Y.numpy(), ref) <= tol
    Z = torch.from_numpy(_block(400, 3, 1, dtype))
    Y2 = dia_spmm(Dt, torch.from_numpy(X), -1.0, 2.0, Z)       # CPU: the plain version
    assert _rel(Y2.numpy(), 2.0 * Z.numpy() - 2.0 * ref) <= tol
    assert dia_spmm.launches == 0


def _hyb_pair(dtype, **kw):
    Aj, At = _both(nearly_banded(dtype=dtype, **kw))
    return J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)


def test_hyb_spmm_plain_matches_pallas_vmap_tile_compact():
    """B3's k-rhs rule (``_vmap_safe_hyb_tc_kernel``), fp32."""
    Hj, Ht = _hyb_pair(np.float32, n_side=40, n_extra=300, seed=7)
    assert Hj.tc_vals is not None
    nb, TS = Hj.tc_vals.shape
    Hd = jax.device_put(Hj)

    def one(x):
        contrib = Hd.tc_vals * lane_gather(x, Hd.tc_cols.reshape(-1)).reshape(nb, TS)
        return dia_spmv_hyb_tc_pallas(Hd, x, contrib, interpret=True)
    X = _block(Ht.shape[0], 3, 1, np.float32)
    ref = np.asarray(jax.vmap(one)(jnp.asarray(X.T))).T
    Y = hyb_spmm_plain(Ht, torch.from_numpy(X))
    assert Y.numpy().dtype == np.float32 and _rel(Y.numpy(), ref) <= 1e-5


def test_hyb_spmm_plain_matches_pallas_vmap_window():
    """B4's k-rhs rule (``_vmap_safe_hyb_kernel``) plus the overflow
    scatter, fp32."""
    Hj, Ht = _hyb_pair(np.float32, n_extra=200, seed=11)
    assert Hj.win_vals is not None
    Sw, nwin = Hj.win_vals.shape
    Hd = jax.device_put(Hj)

    def one(x):
        contrib = Hd.win_vals * lane_gather(x, Hd.win_cols.reshape(-1)).reshape(Sw, nwin)
        y = dia_spmv_hyb_pallas(Hd, x, contrib, interpret=True)
        return y.at[Hd.ovr_rows].add(Hd.ovr_vals * lane_gather(x, Hd.ovr_cols))
    X = _block(Ht.shape[0], 3, 2, np.float32)
    ref = np.asarray(jax.vmap(one)(jnp.asarray(X.T))).T
    assert _rel(hyb_spmm_plain(Ht, torch.from_numpy(X)).numpy(), ref) <= 1e-5


def test_hyb_spmm_plain_matches_jax_fp64():
    Hj, Ht = _hyb_pair(np.float64)
    X = _block(Ht.shape[0], 4, 3)
    ref = np.asarray(jax.vmap(lambda v: jspmv(jax.device_put(Hj), v))(jnp.asarray(X.T))).T
    Y = hyb_spmm(Ht, torch.from_numpy(X))                      # CPU: the plain version
    assert _rel(Y.numpy(), ref) <= 1e-12 and hyb_spmm.launches == 0


def _strayed(pkg, n1d=40, nstray=200, seed=0):
    A = pkg.sparse.laplacian_2d(n1d)
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    r, c = rng.integers(0, n, nstray), rng.integers(0, n, nstray)
    keep = r != c
    E = sp.coo_matrix((0.1 * rng.standard_normal(keep.sum()), (r[keep], c[keep])),
                      shape=A.shape)
    M = (A.to_scipy() + E.tocsr()).tocsr()
    M.sort_indices()
    return pkg.sparse.CSR(M.indptr, M.indices, M.data, M.shape)


def _factors(kind):
    if kind == "banded":
        return (j_iluk(J.sparse.laplacian_2d(40), level=0),
                t_iluk(T.sparse.laplacian_2d(40), level=0))
    return j_iluk(_strayed(J), level=1), t_iluk(_strayed(T), level=1)


@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_neumann_block_plain_matches_pallas_vmap_rule(kind):
    """B5's k-rhs rule (``_vmap_safe_apply``: ``_batched_band_apply`` for
    pure-band factors, a per-column ``lax.map`` of the kernel with
    strays), fp32."""
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    R = _block(Lt.shape[0], 3, 4, np.float32)
    st = jpn.plan_fused_neumann(Lj, Uj, 4)
    ref = np.asarray(jax.vmap(lambda r: jpn.fused_neumann_apply(st, r, interpret=True))(
        jnp.asarray(R.T))).T
    plan = plan_fused_neumann(Lt, Ut, 4, dtype=torch.float32)
    assert (plan.L.stray_ptr is not None or plan.U.stray_ptr is not None) == (kind == "strayed")
    Z = fused_neumann_apply(plan, torch.from_numpy(R))
    assert Z.shape == R.shape and Z.dtype == torch.float32
    assert _rel(Z.numpy(), ref) <= 1e-5
    assert neumann_block_apply.launches == 0 and fused_neumann_apply.launches == 0


@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_neumann_block_plain_matches_jax_fp64(kind):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    R = _block(Lt.shape[0], 3, 5)
    nt = jtri.make_neumann_tri(Lj, Uj, 6)
    ref = np.asarray(jax.vmap(lambda r: jtri.neumann_ilu_apply(nt, r))(jnp.asarray(R.T))).T
    Z = neumann_block_apply(plan_fused_neumann(Lt, Ut, 6), torch.from_numpy(R))
    assert _rel(Z.numpy(), ref) <= 1e-12


# --------------------------------------------------------- block operands = vector path

def _formats():
    A = T.sparse.laplacian_2d(12)
    H = T.sparse.csr_to_hyb(T.sparse.CSR.from_scipy(nearly_banded(n_side=12, n_extra=20)))
    return {"dia": T.sparse.csr_to_dia(A), "hyb": H, "ell": T.sparse.convert.csr_to_ell(A),
            "csr": A.to("cpu")}


@pytest.mark.parametrize("fmt", ["dia", "hyb", "ell", "csr"])
def test_block_products_equal_the_vector_path(fmt):
    M = _formats()[fmt]
    n = M.shape[0]
    X, Y = torch.from_numpy(_block(n, 3, 6)), torch.from_numpy(_block(n, 3, 7))
    ops = [lambda x, y: spmv_mod.spmv(M, x), lambda x, y: spmv_mod.mv_amxy(0.5, M, x),
           lambda x, y: spmv_mod.mv_amxpby(-2.0, M, x, 0.25, y)]
    for op in ops:
        Z = op(X, Y)
        assert Z.shape == (n, 3)
        for c in range(3):
            assert torch.equal(Z[:, c], op(X[:, c].contiguous(), Y[:, c].contiguous()))
        assert torch.equal(op(X[:, :1], Y[:, :1])[:, 0], op(X[:, 0], Y[:, 0]))


@pytest.mark.parametrize("pc,opts", [("none", None), ("jacobi", None),
                                     ("ilu0", T.PCOptions(ilu_sweeps=0)),
                                     ("iluk", T.PCOptions(ilu_sweeps=3)),
                                     ("ilut", T.PCOptions(ilu_sweeps=0, transpose=True))])
def test_every_pc_applies_to_a_block(pc, opts):
    """Column by column to 1e-13: the level schedule's row sums run over a
    non-innermost axis on a block, in another order."""
    A = T.sparse.CSR.from_scipy(nearly_banded(n_side=12, n_extra=20))
    M = T.pc.setup(A, pc, opts, device="cpu")
    X = torch.from_numpy(_block(A.shape[0], 3, 8))
    Z = M(X)
    for c in range(3):
        torch.testing.assert_close(Z[:, c], M(X[:, c].contiguous()), rtol=1e-13, atol=1e-13)
    if pc == "ilut":
        Zt = M.t(X)
        torch.testing.assert_close(Zt[:, 1], M.t(X[:, 1].contiguous()), rtol=1e-13,
                                   atol=1e-13)


def test_level_schedule_block_matches_jax():
    (Lj, Uj), (Lt, Ut) = _factors("strayed")
    R = _block(Lt.shape[0], 3, 9)
    ref = np.asarray(jax.vmap(jtri.make_ilu_apply(Lj, Uj))(jnp.asarray(R.T))).T
    Z = ttri.ilu_apply(ttri.level_schedule(Lt, lower=True), ttri.level_schedule(Ut, lower=False),
                       torch.from_numpy(R))
    assert _rel(Z.numpy(), ref) <= 1e-12


# --------------------------------------------------------------- the per-column path

def test_solve_multi_cg_matches_per_rhs_solves():
    """tests/test_solvers_extra.py TestSolveMulti: cg + iluk, 24², k = 4."""
    Aj, At = J.sparse.laplacian_2d(24), T.sparse.laplacian_2d(24)
    B = _block(At.shape[0], 4, 0)
    Xj, ij = J.solve_multi(Aj, jnp.asarray(B), method="cg", pc="iluk", pc_options=EXACT["j"])
    X, info = T.solve_multi(At, torch.from_numpy(B), method="cg", pc="iluk",
                            pc_options=EXACT["t"])
    assert X.shape == (576, 4) and info.nits.shape == (4,) and info.converged.all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 1).all(), (info.nits, ij.nits)
    for c in range(4):
        x, i = T.solve(At, torch.from_numpy(B[:, c]), method="cg", pc="iluk",
                       pc_options=EXACT["t"])
        assert info.nits[c] == i.nits
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=1e-10, atol=1e-12)
    assert (_relres(At, B, X) <= 1e-6).all()


@pytest.mark.parametrize("method", ["gmres", "rgmres", "bicgstab"])
def test_solve_multi_nonsymmetric_matches_per_rhs(method):
    """gmres (and rgmres, bicgstab) + ilut on convection_diffusion_2d(16,
    beta=10) with the columns ones and arange (TestSolveMulti)."""
    Aj, At = J.sparse.convection_diffusion_2d(16, beta=10.0), \
        T.sparse.convection_diffusion_2d(16, beta=10.0)
    n = At.shape[0]
    B = np.stack([np.ones(n), np.arange(float(n))], axis=1)
    _, ij = J.solve_multi(Aj, jnp.asarray(B), method=method, pc="ilut", pc_options=EXACT["j"])
    X, info = T.solve_multi(At, torch.from_numpy(B), method=method, pc="ilut",
                            pc_options=EXACT["t"])
    assert info.converged.all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 1).all(), (info.nits, ij.nits)
    for c in range(2):
        x, i = T.solve(At, torch.from_numpy(B[:, c]), method=method, pc="ilut",
                       pc_options=EXACT["t"])
        assert info.nits[c] == i.nits
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=1e-10,
                                   atol=1e-10 * np.abs(x.numpy()).max())
        r = np.linalg.norm(B[:, c] - At.to_scipy() @ X[:, c].numpy())
        assert r <= 1e-4 * max(1.0, np.linalg.norm(B[:, c]))


def test_solve_multi_columns_stop_on_their_own():
    """A column that starts converged (zero rhs) reports 0 iterations and
    x = 0 while the others run; the history is (k, maxit+1)."""
    A = T.sparse.laplacian_2d(16)
    B = _block(256, 3, 11)
    B[:, 1] = 0.0
    opts = T.SolverOptions(record_history=True, maxit=300)
    X, info = T.solve_multi(A, torch.from_numpy(B), method="cg", pc="jacobi", options=opts)
    assert info.nits[1] == 0 and info.nits[0] > 0 and info.converged.all()
    assert torch.equal(X[:, 1], torch.zeros(256, dtype=torch.float64))
    assert info.history.shape == (3, 301)
    assert np.isfinite(info.history[0, :info.nits[0] + 1]).all()
    assert np.isnan(info.history[0, info.nits[0] + 1:]).all()


def test_solve_multi_input_errors():
    A = T.sparse.laplacian_2d(8)
    with pytest.raises(ValueError, match="n, k"):
        T.solve_multi(A, torch.ones(64))
    with pytest.raises(ValueError, match="rows"):
        T.solve_multi(A, torch.ones(63, 2))
    with pytest.raises(ValueError, match="unknown solver"):
        T.solve_multi(A, torch.ones(64, 2), method="nope")
    X, info = T.solve_multi(A, np.ones((64, 2), dtype=np.int64), method="cg", device="cpu")
    assert X.dtype == torch.float64 and info.converged.all()


def test_solve_multi_rcm_permutes_the_rows():
    """``reorder="rcm"`` solves the permuted system and returns X in the
    user's order."""
    S = nearly_banded(n_side=12, n_extra=20)
    perm = np.random.default_rng(0).permutation(S.shape[0])
    A = T.sparse.CSR.from_scipy(S[perm][:, perm])
    B = _block(S.shape[0], 2, 12)
    X, info = T.solve_multi(A, torch.from_numpy(B), method="gmres", pc="ilu0", reorder="rcm",
                            options=T.SolverOptions(rtol=1e-10, atol=0, rbtol=0))
    assert info.converged.all() and (_relres(A, B, X) <= 1e-9).all()


# ------------------------------------------------------------------- block CG / GMRES

O_CG = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)


@pytest.fixture(scope="module")
def blockcg_case():
    """TestBlockCG._setup: 48² Poisson, k = 5, iluk; JAX's block and
    per-column counts."""
    Aj, At = J.sparse.laplacian_2d(48), T.sparse.laplacian_2d(48)
    B = _block(At.shape[0], 5, 1)
    _, ibj = J.solve_multi(Aj, jnp.asarray(B), method="blockcg", pc="iluk",
                           options=J.SolverOptions(**O_CG), pc_options=EXACT["j"])
    return Aj, At, B, np.asarray(ibj.nits)


def test_block_cg_true_residual_and_counts(blockcg_case):
    _, At, B, jnits = blockcg_case
    X, info = T.solve_multi(At, torch.from_numpy(B), method="blockcg", pc="iluk",
                            options=T.SolverOptions(**O_CG), pc_options=EXACT["t"])
    assert info.converged.all()
    assert (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - jnits) <= 2).all(), (info.nits, jnits)
    _, ic = T.solve_multi(At, torch.from_numpy(B), method="cg", pc="iluk",
                          options=T.SolverOptions(**O_CG), pc_options=EXACT["t"])
    assert info.nits.max() < ic.nits.min(), (info.nits, ic.nits)


def test_block_cg_duplicate_rhs_in_lockstep(blockcg_case):
    _, At, B, _ = blockcg_case
    B2 = np.tile(B[:, :1], (1, 3))
    X, info = T.solve_multi(At, torch.from_numpy(B2), method="block_cg", pc="iluk",
                            options=T.SolverOptions(**O_CG), pc_options=EXACT["t"])
    assert info.converged.all() and (_relres(At, B2, X) <= 1e-8).all()
    np.testing.assert_allclose(X[:, 0].numpy(), X[:, 2].numpy(), rtol=1e-10, atol=1e-12)


def _gmres_case(k=4, restart=30):
    """TestBlockGMRES._setup: convection_diffusion_2d(48), k columns."""
    Aj, At = J.sparse.convection_diffusion_2d(48), T.sparse.convection_diffusion_2d(48)
    B = _block(At.shape[0], k, 0)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000, restart=restart)
    return Aj, At, B, o


def test_block_gmres_true_residual_and_counts():
    Aj, At, B, o = _gmres_case()
    _, ij = J.solve_multi(Aj, jnp.asarray(B), method="blockgmres", pc="iluk",
                          options=J.SolverOptions(**o), pc_options=EXACT["j"])
    X, info = T.solve_multi(At, torch.from_numpy(B), method="blockgmres", pc="iluk",
                            options=T.SolverOptions(**o), pc_options=EXACT["t"])
    assert info.converged.all() and (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)


def test_block_gmres_no_worse_than_slowest_gmres():
    _, At, B, o = _gmres_case()
    _, ib = T.solve_multi(At, torch.from_numpy(B), method="blockgmres",
                          options=T.SolverOptions(**o))
    _, ig = T.solve_multi(At, torch.from_numpy(B), method="gmres", options=T.SolverOptions(**o))
    assert ib.converged.all()
    m = o["restart"]
    assert ib.nits.max() <= -(-ig.nits.max() // m) * m, (ib.nits, ig.nits)


def test_block_gmres_duplicate_rhs():
    _, At, B, o = _gmres_case()
    B2 = np.stack([B[:, 0], B[:, 0], B[:, 1]], axis=1)
    X, info = T.solve_multi(At, torch.from_numpy(B2), method="blockgmres", pc="iluk",
                            options=T.SolverOptions(**o), pc_options=EXACT["t"])
    assert info.converged.all() and (_relres(At, B2, X) <= 1e-8).all()


def test_block_gmres_restart_cap_honest_unconverged():
    _, At, B, o = _gmres_case()
    o.update(maxit=8, rtol=1e-14)
    X, info = T.solve_multi(At, torch.from_numpy(B), method="blockgmres",
                            options=T.SolverOptions(**o))
    assert not info.converged.any() and info.nits.max() <= 8
    assert torch.isfinite(X).all()


def test_block_gmres_step_granular_nits():
    """One cycle (restart 300): each column's count is no worse than its
    own GMRES count and is not a multiple of the restart."""
    _, At, B, o = _gmres_case(k=3, restart=300)
    _, ib = T.solve_multi(At, torch.from_numpy(B), method="blockgmres",
                          options=T.SolverOptions(**o))
    _, ig = T.solve_multi(At, torch.from_numpy(B), method="gmres", options=T.SolverOptions(**o))
    assert ib.converged.all() and (ib.nits <= ig.nits).all(), (ib.nits, ig.nits)
    assert ((ib.nits >= 1) & (ib.nits < 300)).all()


@pytest.mark.parametrize("method", ["blockgmres", "blockcg"])
def test_block_history(method):
    """record_history gives a (k, maxit+1) trace that starts at r0norm and
    ends at the reported residual (or the tolerance)."""
    A = T.sparse.convection_diffusion_2d(48) if method == "blockgmres" else \
        T.sparse.laplacian_2d(32)
    B = _block(A.shape[0], 3, 1)
    o = T.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000, restart=30,
                        record_history=True)
    _, info = T.solve_multi(A, torch.from_numpy(B), method=method, pc="iluk", options=o,
                            pc_options=EXACT["t"])
    h = info.history
    assert h.shape == (3, 2001)
    np.testing.assert_allclose(h[:, 0], info.r0norm)
    for c in range(3):
        col = h[c][np.isfinite(h[c])]
        assert col[-1] <= 1e-8 * info.bnorm[c] * 1.01 or np.isclose(col[-1], info.residual[c],
                                                                      rtol=1e-3)


# ------------------------------------------------------------------ Solver lifecycle

def test_solver_solve_multi_lifecycle():
    """TestSolverLifecycleMulti, and the scalar solve after a multi solve
    on the same instance (the (n, k) x must not be its warm start)."""
    A = T.sparse.laplacian_2d(32)
    B = torch.from_numpy(_block(A.shape[0], 3, 2))
    o = T.SolverOptions(**O_CG)
    s = T.Solver(method="cg", pc="iluk", options=o, pc_options=EXACT["t"]).assemble(
        A, torch.ones(A.shape[0], dtype=torch.float64))
    X = s.solve_multi(B)
    Xm, im = T.solve_multi(A, B, method="cg", pc="iluk", options=o, pc_options=EXACT["t"])
    np.testing.assert_allclose(X.numpy(), Xm.numpy(), rtol=1e-12)
    assert np.array_equal(s.nits, im.nits) and s.residual.shape == (3,)
    s2 = T.Solver(method="blockcg", pc="iluk", options=o, pc_options=EXACT["t"]).assemble(
        A, torch.ones(A.shape[0], dtype=torch.float64))
    assert (_relres(A, B.numpy(), s2.solve_multi(B)) <= 1e-8).all()
    with pytest.raises(ValueError, match="Solver.solve_multi"):
        s2.solve()
    b1 = torch.ones(A.shape[0], dtype=torch.float64)
    x1 = s.solve(b1)
    assert s.info.converged and np.linalg.norm(1.0 - A.to_scipy() @ x1.numpy()) <= 1e-5
    assert isinstance(s.nits, int) and isinstance(s.residual, float)
    x_ref, i_ref = T.solve(A, b1, method="cg", pc="iluk", options=o, pc_options=EXACT["t"])
    assert s.nits == i_ref.nits          # a cold start, not the (n, k) X


# ----------------------------------------------------------------------- solve_ir_multi

O_IR = dict(rtol=1e-8, atol=0.0, maxit=2000, restart=30)


def _ir_case(k=4, spd=False):
    """TestIRMulti._setup."""
    gen = "laplacian_2d" if spd else "convection_diffusion_2d"
    Aj, At = getattr(J.sparse, gen)(48), getattr(T.sparse, gen)(48)
    return Aj, At, _block(At.shape[0], k, 2)


@pytest.mark.parametrize("method,pc,spd", [("blockgmres", "ilut", False),
                                           ("blockcg", "iluk", True)])
def test_solve_ir_multi_block_inner(method, pc, spd):
    Aj, At, B = _ir_case(spd=spd)
    _, ij = J.solve_ir_multi(Aj, jnp.asarray(B), method=method, pc=pc,
                             options=J.SolverOptions(**O_IR), pc_options=EXACT["j"])
    X, info = T.solve_ir_multi(At, torch.from_numpy(B), method=method, pc=pc,
                               options=T.SolverOptions(**O_IR), pc_options=EXACT["t"])
    assert X.dtype == torch.float64 and info.converged.all()
    assert (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)


def test_solve_ir_multi_per_column_inner_matches_solve_ir():
    """gmres runs the per-column inner (rgmres); converged columns are
    frozen, so each column matches its own solve_ir run."""
    Aj, At, B = _ir_case(k=3)
    _, ij = J.solve_ir_multi(Aj, jnp.asarray(B), method="gmres", pc="ilut",
                             options=J.SolverOptions(**O_IR), pc_options=EXACT["j"])
    X, info = T.solve_ir_multi(At, torch.from_numpy(B), method="gmres", pc="ilut",
                               options=T.SolverOptions(**O_IR), pc_options=EXACT["t"])
    assert info.converged.all() and (_relres(At, B, X) <= 1e-8).all()
    assert (np.abs(info.nits - np.asarray(ij.nits)) <= 2).all(), (info.nits, ij.nits)
    for c in range(3):
        x, i = T.solve_ir(At, torch.from_numpy(B[:, c]), method="gmres", pc="ilut",
                          options=T.SolverOptions(**O_IR), pc_options=EXACT["t"])
        assert abs(info.nits[c] - i.nits) <= 2
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=1e-8, atol=1e-10)


def test_solve_ir_multi_errors():
    _, At, B = _ir_case()
    with pytest.raises(ValueError, match="solve_ir_multi"):
        T.solve_ir(At, torch.from_numpy(B[:, 0]), method="blockgmres")
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        T.solve_ir_multi(At, torch.from_numpy(B[:, 0]), method="blockgmres")
    with pytest.raises(ValueError, match="solve_multi"):
        T.solve(At, torch.from_numpy(B[:, 0]), method="blockcg")
    assert T.solvers.get_block_solver("blockcg") is T.solvers.get_block_solver("block_cg")
    assert T.solvers.get_block_solver("blockgmres").__module__.endswith("block_gmres")
    assert T.solvers.get_block_solver("cg") is None
