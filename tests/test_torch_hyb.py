"""The HYB slice of lssp_tpu_torch (band plus remainder: ``csr_to_hyb``,
``to_device_format``, K3's plain version ``hyb_spmv_plain`` and the mvops
wrappers) against lssp_tpu on the CPU.

The conversion is the same numpy code as the JAX package's, so the band
and the remainder triplets must be identical (the JAX remainder carries
trailing (n−1, 0, 0) padding, which the port drops).  Products: fp64
against JAX's ``spmv`` to rtol 1e-12 (sums in another order); fp32
against the two Pallas HYB kernels run with ``interpret=True`` to
rtol = atol = 2e-5, the tolerance the JAX package's own tests give them.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
from lssp_tpu.ops.pallas_spmv import dia_spmv_hyb_pallas, dia_spmv_hyb_tc_pallas
from lssp_tpu.ops.spmv import lane_gather, mv_amxpby as j_amxpby, spmv as jspmv
import lssp_tpu_torch as T
from lssp_tpu_torch import _kernels, interop
from lssp_tpu_torch.ops import hyb_spmv, hyb_spmv_plain, mv_amxpby, mv_amxy, spmv

MATDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "matrices")


def nearly_banded(n_side=24, n_extra=60, seed=3, dtype=np.float64):
    """TestHYB._nearly_banded (tests/test_sparse.py): a 5-point Laplacian
    plus a sprinkle of 0.01 entries at random positions, as scipy CSR."""
    rng = np.random.default_rng(seed)
    S = J.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] = S[i, j] + 0.01
    return S.tocsr().astype(dtype)


def _vendored(name):
    return sp.csr_matrix(J.sparse.read_matrix_market(
        os.path.join(MATDIR, name + ".mtx.gz")).to_scipy())


def _both(S):
    return J.sparse.CSR.from_scipy(S), T.sparse.CSR.from_scipy(S)


MATRICES = {
    "nearly_banded": lambda: nearly_banded(),
    "nearly_banded_200": lambda: nearly_banded(n_side=40, n_extra=200, seed=11),
    "coupled3d_25": lambda: _vendored("coupled3d_25"),
    "convdiff_rot_128": lambda: _vendored("convdiff_rot_128"),
}


def _jax_rem(Hj, nrem):
    """The JAX remainder triplets without their trailing padding."""
    r, c, v = (np.asarray(a) for a in (Hj.rem_rows, Hj.rem_cols, Hj.rem_vals))
    n = Hj.shape[0]
    assert np.all(r[nrem:] == n - 1) and np.all(c[nrem:] == 0) and np.all(v[nrem:] == 0)
    return r[:nrem], c[:nrem], v[:nrem]


@pytest.mark.parametrize("name", list(MATRICES))
def test_csr_to_hyb_identical(name):
    Aj, At = _both(MATRICES[name]())
    Hj, Ht = J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)
    assert Hj.dia.offsets == Ht.dia.offsets
    assert np.array_equal(np.asarray(Hj.dia.data), Ht.dia.data.numpy())
    r, c, v = _jax_rem(Hj, Ht.nnz_rem)
    assert np.array_equal(r, Ht.rem_rows.numpy())
    assert np.array_equal(c, Ht.rem_cols.numpy())
    assert np.array_equal(v, Ht.rem_vals.numpy())
    assert Ht.rem_rows.dtype == Ht.rem_cols.dtype == torch.int32
    assert np.array_equal(Ht.todense(), At.todense())
    from lssp_tpu.sparse.convert import band_occupancy
    assert T.sparse.band_occupancy(At) == band_occupancy(Aj)
    assert T.sparse.band_occupancy(At, max_diags=3, min_occ=0.5) == \
        band_occupancy(Aj, max_diags=3, min_occ=0.5)
    # the JAX container carried across gives the same HYB
    Hi = interop.hyb_from_arrays(Hj.dia.offsets, np.asarray(Hj.dia.data), Hj.rem_rows,
                                 Hj.rem_cols, Hj.rem_vals, Hj.shape)
    for f in ("rem_rows", "rem_cols", "rem_vals", "rem_block_ptr"):
        assert torch.equal(getattr(Hi, f), getattr(Ht, f)), f


@pytest.mark.parametrize("case", ["random", "min_cover", "wide"])
def test_csr_to_hyb_rejects_like_jax(case):
    if case == "random":
        S, kw = sp.csr_matrix(J.sparse.random_sparse(300, seed=2).to_scipy()), {}
    elif case == "min_cover":
        S, kw = nearly_banded(), {"min_cover": 0.999}
    else:
        S, kw = sp.random(10, 30, density=0.3, random_state=1, format="csr"), {}
    Aj, At = _both(S)
    with pytest.raises(ValueError) as ej:
        J.sparse.csr_to_hyb(Aj, **kw)
    with pytest.raises(ValueError) as et:
        T.sparse.csr_to_hyb(At, **kw)
    assert str(et.value) == str(ej.value)


FORMAT_CASES = {
    "laplacian_2d": lambda: sp.csr_matrix(J.sparse.laplacian_2d(12).to_scipy()),
    "nearly_banded": lambda: nearly_banded(),
    "random_sparse": lambda: sp.csr_matrix(J.sparse.random_sparse(200, seed=4).to_scipy()),
    "coupled3d_25": lambda: _vendored("coupled3d_25"),
    "convdiff_rot_128": lambda: _vendored("convdiff_rot_128"),
}


@pytest.mark.parametrize("name", list(FORMAT_CASES))
def test_to_device_format_same_class(name):
    Aj, At = _both(FORMAT_CASES[name]())
    fj, ft = J.sparse.to_device_format(Aj), T.sparse.to_device_format(At, device="cpu")
    assert type(ft).__name__ == type(fj).__name__
    assert np.array_equal(ft.todense(), At.todense())


def test_hyb_container():
    A = T.sparse.CSR.from_scipy(nearly_banded(n_side=30, n_extra=90, seed=5))
    H = T.sparse.csr_to_hyb(A)
    n = A.shape[0]
    R = _kernels.HYB_BLOCK_ROWS
    assert n % R != 0
    ptr, rows = H.rem_block_ptr.numpy(), H.rem_rows.numpy()
    assert len(ptr) == -(-n // R) + 1 and ptr[0] == 0 and ptr[-1] == H.nnz_rem
    for b in range(len(ptr) - 1):           # block b holds exactly its rows' entries
        seg = rows[ptr[b]:ptr[b + 1]]
        assert np.all(seg // R == b)
    H32 = H.to(dtype=torch.float32)
    assert H32.dtype == torch.float32 and H32.rem_vals.dtype == torch.float32
    assert H32.rem_rows.dtype == H32.rem_cols.dtype == H32.rem_block_ptr.dtype == torch.int32
    assert np.allclose(H32.todense(), A.todense(), rtol=1e-6)


def test_hyb_from_parts_rejects_bad_triplets():
    D = T.sparse.csr_to_dia(T.sparse.laplacian_2d(4))
    with pytest.raises(ValueError, match="row-sorted"):
        T.sparse.convert.hyb_from_parts(D, [3, 1], [0, 0], np.ones(2), (16, 16))
    with pytest.raises(ValueError, match="inside"):
        T.sparse.convert.hyb_from_parts(D, [1, 3], [0, 16], np.ones(2), (16, 16))
    with pytest.raises(ValueError, match="length"):
        T.sparse.convert.hyb_from_parts(D, [1, 3], [0], np.ones(2), (16, 16))


def test_to_device_format_raises_layout_errors(monkeypatch):
    """Only a band too thin for HYB sends a matrix to ELL; a remainder K3
    cannot take raises instead of switching to the gather path."""
    def refuse(*args, **kwargs):
        raise ValueError("HYB indexes rows, columns and remainder entries in int32")
    A = T.sparse.CSR.from_scipy(nearly_banded())
    assert isinstance(T.sparse.to_device_format(A, device="cpu"), T.sparse.HYB)
    monkeypatch.setattr(T.sparse.convert, "hyb_from_parts", refuse)
    with pytest.raises(ValueError, match="int32"):
        T.sparse.to_device_format(A, device="cpu")


def _x(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", ["nearly_banded", "coupled3d_25"])
def test_hyb_plain_matches_jax_spmv_fp64(name):
    Aj, At = _both(MATRICES[name]())
    Hj, Ht = J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)
    x = _x(At.shape[0], 0)
    yj = np.asarray(jspmv(jax.device_put(Hj), jnp.asarray(x)))
    yt = hyb_spmv_plain(Ht, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    assert np.array_equal(spmv(Ht, torch.from_numpy(x)).numpy(), yt)   # CPU: plain
    assert np.array_equal(hyb_spmv(Ht, torch.from_numpy(x)).numpy(), yt)


def test_hyb_plain_matches_pallas_tile_compact_fp32():
    S = nearly_banded(n_side=40, n_extra=300, seed=7, dtype=np.float32)
    Aj, At = _both(S)
    Hj, Ht = J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)
    assert Hj.tc_vals is not None
    nb, TS = Hj.tc_vals.shape
    x = _x(At.shape[0], 1, np.float32)
    xj = jnp.asarray(x)
    contrib = jnp.asarray(Hj.tc_vals) * lane_gather(xj, jnp.asarray(Hj.tc_cols).reshape(-1)
                                                    ).reshape(nb, TS)
    yj = np.asarray(dia_spmv_hyb_tc_pallas(jax.device_put(Hj), xj, contrib, interpret=True))
    yt = hyb_spmv_plain(Ht, torch.from_numpy(x)).numpy()
    assert yt.dtype == np.float32
    np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=2e-5)


def test_hyb_plain_matches_pallas_window_fp32():
    S = nearly_banded(n_extra=200, seed=11, dtype=np.float32)
    Aj, At = _both(S)
    Hj, Ht = J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)
    assert Hj.win_vals is not None
    Sw, nwin = Hj.win_vals.shape
    x = _x(At.shape[0], 2, np.float32)
    xj = jnp.asarray(x)
    contrib = jnp.asarray(Hj.win_vals) * lane_gather(
        xj, jnp.asarray(Hj.win_cols).reshape(-1)).reshape(Sw, nwin)
    yj = dia_spmv_hyb_pallas(jax.device_put(Hj), xj, contrib, interpret=True)
    yj = np.asarray(yj.at[jnp.asarray(Hj.ovr_rows)].add(
        jnp.asarray(Hj.ovr_vals) * lane_gather(xj, jnp.asarray(Hj.ovr_cols))))
    yt = hyb_spmv_plain(Ht, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.25, 0.0), (1.0, 1.0), (-2.0, 0.5)])
def test_hyb_mvops_match_jax(alpha, beta):
    Aj, At = _both(nearly_banded(n_extra=150, seed=9))
    Hj, Ht = J.sparse.csr_to_hyb(Aj), T.sparse.csr_to_hyb(At)
    n = At.shape[0]
    x, z = _x(n, 3), _x(n, 4)
    want = np.asarray(j_amxpby(alpha, jax.device_put(Hj), jnp.asarray(x), beta, jnp.asarray(z)))
    got = mv_amxpby(alpha, Ht, torch.from_numpy(x), beta, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    plain = hyb_spmv_plain(Ht, torch.from_numpy(x), alpha, beta, torch.from_numpy(z))
    assert np.array_equal(plain.numpy(), got)
    S = At.to_scipy()
    assert _rel(mv_amxy(alpha, Ht, torch.from_numpy(x)).numpy(), alpha * (S @ x)) <= 1e-13


def test_hyb_empty_remainder_and_heavy_row():
    """A HYB with no remainder, and one whose remainder sits mostly in one
    row, both in the plain product against scipy."""
    L = sp.csr_matrix(J.sparse.laplacian_2d(20).to_scipy())
    D = T.sparse.csr_to_dia(T.sparse.CSR.from_scipy(L))
    H0 = T.sparse.convert.hyb_from_parts(D, [], [], np.zeros(0), L.shape)
    assert H0.nnz_rem == 0 and H0.rem_block_ptr.numpy().tolist() == [0, 0, 0]
    x = _x(400, 5)
    assert _rel(hyb_spmv_plain(H0, torch.from_numpy(x)).numpy(), L @ x) <= 1e-15
    cols = np.arange(0, 400, 3)
    rows = np.full(len(cols), 217)
    E = sp.csr_matrix((np.full(len(cols), 0.5), (rows, cols)), shape=L.shape)
    Hh = T.sparse.convert.hyb_from_parts(D, rows, cols, np.full(len(cols), 0.5), L.shape)
    assert _rel(hyb_spmv_plain(Hh, torch.from_numpy(x)).numpy(), (L + E) @ x) <= 1e-14
