"""lssp_tpu_torch sparse layer and host ILU against lssp_tpu on the CPU.

Generators, conversions and the execution-format choice must be identical
to the JAX package's (same numpy code); ILU factors must be bit-identical
(same native C++ built with the same flags).  Exact equality throughout.
"""
import dataclasses

import numpy as np
import pytest
import torch

import lssp_tpu as J
import lssp_tpu.pc.ilu_host as Jh
import lssp_tpu_torch as T
import lssp_tpu_torch.pc.ilu_host as Th
from lssp_tpu_torch import interop


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


GENERATORS = [
    ("laplacian_2d", (12,), {}),
    ("laplacian_3d", (6,), {}),
    ("anisotropic_poisson_2d", (10,), {"epsilon": 0.01}),
    ("convection_diffusion_2d", (10,), {}),
    ("elasticity_2d", (6,), {}),
    ("random_sparse", (60,), {"nnz_per_row": 5, "seed": 3}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_identical(name, args, kw):
    _same_csr(getattr(J.sparse, name)(*args, **kw), getattr(T.sparse, name)(*args, **kw))


def _pair(name, *args, **kw):
    return getattr(J.sparse, name)(*args, **kw), getattr(T.sparse, name)(*args, **kw)


@pytest.mark.parametrize("name,args", [("laplacian_2d", (9,)), ("laplacian_3d", (5,)),
                                       ("convection_diffusion_2d", (8,))])
def test_csr_to_dia_identical(name, args):
    Aj, At = _pair(name, *args)
    Dj, Dt = J.sparse.csr_to_dia(Aj), T.sparse.csr_to_dia(At)
    assert Dj.offsets == Dt.offsets and Dj.shape == Dt.shape
    assert np.array_equal(np.asarray(Dj.data), Dt.data.numpy())
    D32 = T.sparse.csr_to_dia(At, dtype=np.float32)
    assert D32.dtype == torch.float32
    assert np.array_equal(np.asarray(Dj.data).astype(np.float32), D32.data.numpy())


def test_csr_to_dia_rejects_too_many_diagonals():
    with pytest.raises(ValueError, match="max_diags"):
        T.sparse.csr_to_dia(T.sparse.random_sparse(80, seed=1), max_diags=8)


@pytest.mark.parametrize("name,args,kw", [("random_sparse", (70,), {"seed": 5}),
                                          ("laplacian_2d", (7,), {})])
def test_csr_to_ell_identical(name, args, kw):
    Aj, At = _pair(name, *args, **kw)
    Ej, Et = J.sparse.csr_to_ell(Aj), T.sparse.csr_to_ell(At)
    assert np.array_equal(np.asarray(Ej.cols), Et.cols.numpy())
    assert np.array_equal(np.asarray(Ej.data), Et.data.numpy())
    assert np.array_equal(Et.todense(), At.todense())


@pytest.mark.parametrize("name,args,kw", [
    ("laplacian_2d", (10,), {}), ("laplacian_3d", (6,), {}),
    ("elasticity_2d", (5,), {}), ("random_sparse", (300,), {"seed": 2})])
def test_to_device_format_choice(name, args, kw):
    """The same container class as the JAX package picks: DIA, HYB or ELL,
    with the same band."""
    Aj, At = _pair(name, *args, **kw)
    fj, ft = J.sparse.to_device_format(Aj), T.sparse.to_device_format(At, device="cpu")
    assert type(ft).__name__ == type(fj).__name__
    if isinstance(fj, J.sparse.DIA):
        assert fj.offsets == ft.offsets
        assert np.array_equal(np.asarray(fj.data), ft.data.numpy())
    elif isinstance(fj, J.sparse.HYB):
        assert fj.dia.offsets == ft.dia.offsets
        assert np.array_equal(np.asarray(fj.dia.data), ft.dia.data.numpy())
    assert np.array_equal(ft.todense(), At.todense())


def test_to_device_format_runs_on_the_card_unless_asked(monkeypatch):
    """With no ``device=`` the conversion follows ``config.resolve_device``,
    as the solve entry points do: the same RuntimeError without a CUDA
    device, the current CUDA device with one."""
    A = T.sparse.laplacian_2d(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.sparse.to_device_format(A)
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(T.sparse.convert, "csr_to_dia",
                        lambda A, **kw: seen.append(kw["device"]))
    T.sparse.to_device_format(A)
    assert seen == [torch.device("cuda", 3)]


def test_csr_utils_identical():
    rng = np.random.default_rng(7)
    Aj = J.sparse.random_sparse(40, nnz_per_row=4, seed=4)
    # shuffle columns within rows, drop some diagonals
    ip = np.asarray(Aj.indptr)
    idx, dat = np.asarray(Aj.indices).copy(), np.asarray(Aj.data).copy()
    for i in range(40):
        p = rng.permutation(ip[i + 1] - ip[i]) + ip[i]
        idx[ip[i]:ip[i + 1]], dat[ip[i]:ip[i + 1]] = idx[p], dat[p]
    Uj = J.sparse.CSR(ip, idx, dat, Aj.shape)
    Ut = interop.csr_from_arrays(ip, idx, dat, Aj.shape)
    _same_csr(J.sparse.sort_columns(Uj), T.sparse.sort_columns(Ut))
    Sj, St = J.sparse.sort_columns(Uj), T.sparse.sort_columns(Ut)
    _same_csr(J.sparse.transpose(Sj), T.sparse.transpose(St))
    keep = np.asarray(St.indices) != np.repeat(np.arange(40), np.diff(ip))
    keep[::3] = True
    sc = St.to_scipy().copy()
    sc.data[~keep] = 0
    sc.eliminate_zeros()
    _same_csr(J.sparse.adjust_zero_diag(J.sparse.CSR.from_scipy(sc)),
              T.sparse.adjust_zero_diag(T.sparse.CSR.from_scipy(sc)))
    (lj, dj, uj), (lt_, dt_, ut) = J.sparse.split_ldu(Sj), T.sparse.split_ldu(St)
    _same_csr(lj, lt_)
    _same_csr(uj, ut)
    assert np.array_equal(dj, dt_)
    assert np.array_equal(J.sparse.diagonal(Sj), T.sparse.diagonal(St))


FACTOR_MATRICES = [("convection_diffusion_2d", (14,), {}),
                   ("random_sparse", (150,), {"nnz_per_row": 6, "seed": 11})]


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("name,args,kw", FACTOR_MATRICES, ids=[m[0] for m in FACTOR_MATRICES])
def test_iluk_factors_bit_identical(name, args, kw, level):
    Aj, At = _pair(name, *args, **kw)
    for (Lj, Uj), (Lt, Ut) in ((Jh.iluk_factor(Aj, level=level), Th.iluk_factor(At, level=level)),
                               (Jh.iluk_factor(Aj.astype(np.float32), level=level),
                                Th.iluk_factor(At.astype(np.float32), level=level))):
        _same_csr(Lj, Lt)
        _same_csr(Uj, Ut)
    _same_csr(Jh.iluk_symbolic(Aj, level), Th.iluk_symbolic(At, level))


@pytest.mark.parametrize("tol,p", [(None, None), (1e-2, 3)])
@pytest.mark.parametrize("name,args,kw", FACTOR_MATRICES, ids=[m[0] for m in FACTOR_MATRICES])
def test_ilut_factors_bit_identical(name, args, kw, tol, p):
    Aj, At = _pair(name, *args, **kw)
    (Lj, Uj), (Lt, Ut) = Jh.ilut_factor(Aj, tol=tol, p=p), Th.ilut_factor(At, tol=tol, p=p)
    _same_csr(Lj, Lt)
    _same_csr(Uj, Ut)


def test_block_diag_iluk_bit_identical():
    Aj, At = _pair("laplacian_2d", 8)
    (Lj, Uj), (Lt, Ut) = (Jh.iluk_factor(Aj, level=1, num_blocks=4),
                          Th.iluk_factor(At, level=1, num_blocks=4))
    _same_csr(Lj, Lt)
    _same_csr(Uj, Ut)


def test_interop_round_trip():
    """JAX state → numpy → port containers, then both packages compute."""
    import jax.numpy as jnp
    from lssp_tpu.ops.spmv import spmv as jspmv
    from lssp_tpu_torch.ops.spmv import spmv as tspmv
    Aj = J.sparse.laplacian_3d(5)
    At = interop.csr_from_arrays(np.asarray(Aj.indptr), np.asarray(Aj.indices),
                                 np.asarray(Aj.data), Aj.shape)
    _same_csr(Aj, At)
    Dj = J.sparse.csr_to_dia(Aj)
    Dt = interop.dia_from_arrays(Dj.offsets, np.asarray(Dj.data), Dj.shape)
    x = np.random.default_rng(0).standard_normal(Aj.shape[0])
    # same accumulation order in both packages: bitwise equal in fp64
    assert np.array_equal(np.asarray(jspmv(Dj, jnp.asarray(x))),
                          tspmv(Dt, torch.from_numpy(x)).numpy())
    Lj, Uj = Jh.iluk_factor(Aj, level=1)
    arrays = [tuple(np.asarray(getattr(F, f)) for f in ("indptr", "indices", "data"))
              + (F.shape,) for F in (Lj, Uj)]
    Lt, Ut = interop.ilu_factors_from_arrays(*arrays)
    _same_csr(Lj, Lt)
    _same_csr(Uj, Ut)
    assert dataclasses.is_dataclass(Lt) and isinstance(Lt, T.sparse.CSR)
