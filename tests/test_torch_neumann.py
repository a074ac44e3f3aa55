"""K2's plan and plain version, and the exact triangular solves, against
lssp_tpu on the CPU.

- The band/stray plan equals the TPU plan's ``_split_band`` exactly.
- ``neumann_apply_plain`` matches the Pallas kernel ``fused_neumann_apply``
  run with ``interpret=True`` in fp32 (rtol 1e-5: another summation order
  over 2k sweeps), and the JAX SpMV-composed ``neumann_ilu_apply`` in fp64
  (1e-12).
- The exact level-scheduled apply matches JAX's and a dense solve (1e-12).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops import pallas_neumann as jpn
from lssp_tpu.ops import trisolve as jtri
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
import lssp_tpu_torch as T
from lssp_tpu_torch.ops import trisolve as ttri
from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                        plan_fused_neumann, split_band)
from lssp_tpu_torch.pc.ilu_host import iluk_factor as t_iluk


def _strayed(pkg, n1d, nstray, seed=0):
    """2-D Laplacian plus random long-range couplings: a dominant band with
    a scattered remainder (the pattern of tests/test_pallas_neumann.py)."""
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
    """(JAX factors, port factors) — bit-identical, see test_torch_sparse."""
    if kind == "banded":
        return j_iluk(J.sparse.laplacian_2d(40), level=0), t_iluk(T.sparse.laplacian_2d(40), level=0)
    return j_iluk(_strayed(J, 40, 200), level=1), t_iluk(_strayed(T, 40, 200), level=1)


@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plan_split_matches_tpu_plan(kind):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    n = Lt.shape[0]
    st_j = jpn.plan_fused_neumann(Lj, Uj, 2)
    plan = plan_fused_neumann(Lt, Ut, 2, dtype=torch.float32)
    for Fj, Ft in ((st_j.L, plan.L), (st_j.U, plan.U)):
        assert Fj.offsets == Ft.offsets
        assert np.array_equal(np.asarray(Fj.band)[:, :n], Ft.band.numpy())
        has_j, has_t = Fj.gt is not None, Ft.stray_ptr is not None
        assert has_j == has_t
        if has_t:   # the same stray entries: one per one-hot row of the TPU plan
            assert int(np.asarray(Fj.gt).sum()) == Ft.stray_cols.numel()
    assert np.array_equal(np.asarray(st_j.invdiag)[:n], plan.invdiag.numpy())
    assert (kind == "strayed") == (plan.L.stray_ptr is not None or plan.U.stray_ptr is not None)


def test_split_band_rule_on_host():
    (_, _), (Lt, _) = _factors("strayed")
    Ls, _, _ = T.sparse.split_ldu(Lt)
    n = Lt.shape[0]
    band, offs, (rows, cols, vals) = split_band(Ls, n)
    bj, oj, (rj, cj, vj) = jpn._split_band(J.sparse.CSR(Ls.indptr, Ls.indices, Ls.data, Ls.shape),
                                           n, n, 48, 0.02)
    assert offs == oj
    assert np.array_equal(band.astype(np.float32), bj)
    assert np.array_equal(rows, rj) and np.array_equal(cols, cj) and np.array_equal(vals, vj)


@pytest.mark.parametrize("sweeps", [2, 6])
@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plain_matches_pallas_fp32(kind, sweeps):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    r = np.random.default_rng(sweeps).standard_normal(Lt.shape[0])
    z_pallas = np.asarray(jpn.fused_neumann_apply(jpn.plan_fused_neumann(Lj, Uj, sweeps),
                                                  jnp.asarray(r, jnp.float32),
                                                  interpret=True))
    plan = plan_fused_neumann(Lt, Ut, sweeps, dtype=torch.float32)
    z = fused_neumann_apply(plan, torch.from_numpy(r.astype(np.float32)))
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), z_pallas, rtol=1e-5, atol=1e-6)
    assert fused_neumann_apply.launches == 0      # CPU tensors take the plain version


@pytest.mark.parametrize("sweeps", [2, 6])
@pytest.mark.parametrize("kind", ["banded", "strayed"])
def test_plain_matches_neumann_ilu_apply_fp64(kind, sweeps):
    (Lj, Uj), (Lt, Ut) = _factors(kind)
    r = np.random.default_rng(10 + sweeps).standard_normal(Lt.shape[0])
    z_jax = np.asarray(jtri.neumann_ilu_apply(jtri.make_neumann_tri(Lj, Uj, sweeps),
                                              jnp.asarray(r)))
    plan = plan_fused_neumann(Lt, Ut, sweeps)
    assert plan.dtype == torch.float64
    z = neumann_apply_plain(plan, torch.from_numpy(r))
    np.testing.assert_allclose(z.numpy(), z_jax, rtol=1e-12, atol=1e-12)
    # the port's own SpMV-composed apply (the transpose-capable setup)
    z2 = ttri.neumann_ilu_apply(ttri.make_neumann_tri(Lt, Ut, sweeps), torch.from_numpy(r))
    np.testing.assert_allclose(z2.numpy(), z_jax, rtol=1e-12, atol=1e-12)


def test_apply_requires_the_plan_dtype():
    (_, _), (Lt, Ut) = _factors("banded")
    plan = plan_fused_neumann(Lt, Ut, 2, dtype=torch.float32)
    with pytest.raises(TypeError, match="plan"):
        fused_neumann_apply(plan, torch.zeros(Lt.shape[0], dtype=torch.float64))


def test_complete_neumann_is_exact():
    """sweeps = dependency depth: the finite Neumann series is the exact
    triangular solve (the ilu_sweeps=-1 contract)."""
    A = T.sparse.laplacian_2d(7)
    L, U = t_iluk(A, level=1)
    depth = ttri.neumann_exact_depth(
        [(S.indptr, S.indices, 49, low) for S, low in
         ((T.sparse.split_ldu(L)[0], True), (T.sparse.split_ldu(U)[2], False))])
    r = np.random.default_rng(4).standard_normal(49)
    z = neumann_apply_plain(plan_fused_neumann(L, U, depth), torch.from_numpy(r))
    ref = np.linalg.solve(U.todense(), np.linalg.solve(L.todense() + np.eye(49), r))
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("transpose", [False, True])
def test_exact_level_apply_matches_jax(transpose):
    (Lj, Uj), (Lt, Ut) = _factors("strayed")
    n = Lt.shape[0]
    r = np.random.default_rng(5).standard_normal(n)
    if transpose:
        z_jax = jtri.ilu_apply_t(*jtri.ilu_transpose_schedules(Lj, Uj), jnp.asarray(r))
        z = ttri.ilu_apply_t(*ttri.ilu_transpose_schedules(Lt, Ut), torch.from_numpy(r))
        Md = (Ut.todense().T, Lt.todense().T + np.eye(n))
    else:
        z_jax = jtri.make_ilu_apply(Lj, Uj)(jnp.asarray(r))
        z = ttri.ilu_apply(ttri.level_schedule(Lt, lower=True),
                           ttri.level_schedule(Ut, lower=False), torch.from_numpy(r))
        Md = (Lt.todense() + np.eye(n), Ut.todense())
    ref = np.linalg.solve(Md[1], np.linalg.solve(Md[0], r))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(z.numpy(), ref, rtol=1e-10, atol=1e-10)


def test_ilu_pc_sweep_resolution():
    """ilu_sweeps None → exact on the CPU (the fused K2 plan on CUDA);
    k > 0 → the K2 plan, also when transpose=True is asked for, which raises
    because the Neumann M⁻ᵀ apply is not ported; a setup without transpose
    raises on M.t instead of applying M⁻¹."""
    A = T.sparse.laplacian_2d(8)
    assert T.pc.setup(A, "ilu0", device="cpu").name == "ilu0"
    assert T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=3), device="cpu").name == "ilu0-fn3"
    with pytest.raises(NotImplementedError, match="transpose SpMV"):
        T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=3, transpose=True), device="cpu")
    with pytest.raises(ValueError, match="transpose"):
        T.pc.setup(A, "ilu0", device="cpu").t(torch.ones(64, dtype=torch.float64))
    Mt = T.pc.setup(A, "ilu0", T.PCOptions(ilu_sweeps=0, transpose=True),
                    device="cpu")
    assert Mt.t(torch.ones(64, dtype=torch.float64)).shape == (64,)
    assert ttri.default_ilu_sweeps("cpu") == 0 and ttri.default_ilu_sweeps("cuda") == 6
    M = T.pc.setup(A, "iluk", T.PCOptions(ilu_sweeps=2), device="cpu")
    assert dataclasses.is_dataclass(M.state)
