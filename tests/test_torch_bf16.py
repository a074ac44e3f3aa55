"""The bfloat16 inner precision of ``solve_ir`` against lssp_tpu on the CPU.

numpy has no bfloat16, so the port holds bf16 values in float32 on the host
and rounds in torch (``sparse/types.round_values``); JAX's numpy side uses
ml_dtypes.  Both round to nearest even through float32, so:

- the bf16 ILU factors, and the level schedules built from them, equal
  JAX's bit for bit (16-bit patterns compared);
- the plain bf16 products (K1, K3, K4 and their k-rhs forms: float32 sums,
  one rounding) agree with JAX's XLA products in bf16 (a rounding per
  operation) to nd × 2⁻⁸ relative to max|y|;
- ``solve_ir`` / ``solve_ir_multi`` / ``dist_solve_ir`` in bf16 reach
  JAX's residual bound with JAX's inner counts + 15 % (bf16 counts move
  with rounding far more than fp32 ones, ROADMAP C 10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import lssp_tpu as J
from lssp_tpu import pc as jpc
from lssp_tpu.ops.spmv import mv_amxy as j_amxy, spmv as jspmv
from lssp_tpu.parallel import dist_ops as jops
from lssp_tpu.parallel import dist_solve as jsolve
from lssp_tpu.parallel import partition as jpart
from lssp_tpu.pc.ilu_host import iluk_factor as j_iluk
import lssp_tpu_torch as T
from lssp_tpu_torch import _kernels
from lssp_tpu_torch.ops import (
    dia_spmm, dia_spmv, fused_neumann_apply, hyb_spmm_plain, hyb_spmv, mv_amxy,
    plan_fused_neumann,
)
from lssp_tpu_torch.ops.trisolve import CompactSchedule, TriSchedule
from lssp_tpu_torch.parallel import partition as tpart
from lssp_tpu_torch.parallel.dist_ops import make_dist_spmv
from lssp_tpu_torch.pc.base import round_factor, rounding_to
from lssp_tpu_torch.pc.ilu_host import iluk_factor as t_iluk
from lssp_tpu_torch.sparse.types import round_to, round_values

BF16 = torch.bfloat16
JBF16 = np.dtype(ml_dtypes.bfloat16)
O = dict(rtol=1e-8, atol=0.0, rbtol=0.0)


def bits_t(a) -> np.ndarray:
    """The 16-bit patterns of a port bf16 value array (tensor or float32)."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    return t.to(BF16).view(torch.int16).numpy().view(np.uint16)


def bits_j(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == JBF16
    return a.view(np.uint16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def within_one_ulp(y: torch.Tensor, exact: np.ndarray) -> bool:
    """Every entry of the bf16 ``y`` within one bf16 ulp (2⁻⁷ relative) of
    the float64 ``exact``, over the entries with |exact| ≥ 1e-3·max."""
    yv = y.double().numpy()
    keep = np.abs(exact) >= 1e-3 * np.abs(exact).max()
    return bool(np.all(np.abs(yv - exact)[keep] <= 2**-7 * np.abs(exact)[keep]))


def _x(n, seed, k=None):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


MATS = {"laplacian_3d_8": lambda S: S.laplacian_3d(8),
        "convdiff_16": lambda S: S.convection_diffusion_2d(16, beta=15.0)}


def test_round_values_is_nearest_even_through_float32():
    v = np.array([1 + 2**-8 + 2**-30, 1 + 2**-8, 1 + 3 * 2**-8, -0.1, 3.0e38])
    assert np.array_equal(bits_t(round_values(v, BF16)), bits_j(v.astype(JBF16)))
    assert round_values(v, BF16).dtype == np.float32
    assert round_values(v, torch.float32).dtype == np.float32


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("name", list(MATS))
def test_bf16_ilu_factors_equal_jax_bitwise(name, level):
    """JAX rounds A to bf16, factors in fp64 and rounds the factors once;
    the port rounds at the same two points, through torch."""
    Aj, At = MATS[name](J.sparse), MATS[name](T.sparse)
    Lj, Uj = j_iluk(Aj.astype(JBF16), level=level)
    with rounding_to(BF16):
        Lt, Ut = (round_factor(F) for F in t_iluk(round_to(At, BF16), level=level))
    for Fj, Ft in ((Lj, Lt), (Uj, Ut)):
        assert np.array_equal(np.asarray(Fj.indptr), Ft.indptr)
        assert np.array_equal(np.asarray(Fj.indices), Ft.indices)
        assert np.array_equal(bits_j(Fj.data), bits_t(Ft.data))


def _dense_bits(rows, cols, vals, n):
    """A padded (JAX) schedule's entries as a dense (n, n) array of 16-bit
    patterns (padding points at row / column n)."""
    out = np.zeros((n + 1, n + 1), np.uint16)
    out[np.broadcast_to(rows[..., None], cols.shape), cols] = vals
    return out[:n, :n]


def _port_dense_bits(st, n):
    """The same for the port's schedule, padded or compact."""
    if isinstance(st, TriSchedule):
        return _dense_bits(st.rows.numpy(), st.cols.numpy(), bits_t(st.vals), n)
    order = st.order.numpy()
    counts = np.concatenate([np.diff(seg.numpy()) if seg is not None
                             else np.zeros(st.lev_ptr[l + 1] - st.lev_ptr[l], np.int64)
                             for l, seg in enumerate(st.seg)])
    out = np.zeros((n, n), np.uint16)
    out[np.repeat(order, counts), order[st.cols.numpy()]] = bits_t(st.vals)
    return out


@pytest.mark.parametrize("pc", ["ilu0", "iluk"])
@pytest.mark.parametrize("name", list(MATS))
def test_bf16_pc_schedules_equal_jax_bitwise(name, pc):
    """``pc.setup(..., dtype=bf16)``: the exact schedules' values and 1/diag
    are JAX's bf16 state bit for bit, and the apply runs in bf16."""
    Aj, At = MATS[name](J.sparse), MATS[name](T.sparse)
    Mj = jpc.setup(Aj.astype(JBF16), pc, J.PCOptions(ilu_sweeps=0))
    Mt = T.pc.setup(At, pc, T.PCOptions(ilu_sweeps=0), device="cpu", dtype=BF16)
    n = At.shape[0]
    for sj, st in zip(Mj.state[:2], Mt.state[:2]):
        assert st.vals.dtype == BF16
        assert np.array_equal(_dense_bits(np.asarray(sj.rows), np.asarray(sj.cols),
                                          bits_j(sj.vals), n), _port_dense_bits(st, n))
        if sj.invdiag is not None:
            inv = bits_t(st.invdiag)
            if isinstance(st, CompactSchedule):            # held in level order
                inv = inv[np.argsort(st.order.numpy())]
            assert np.array_equal(bits_j(sj.invdiag), inv)
    r = _x(At.shape[0], 3)
    zj = np.asarray(Mj(jnp.asarray(r, jnp.bfloat16)), np.float64)
    zt = Mt(torch.from_numpy(r).to(BF16))
    assert zt.dtype == BF16
    assert _rel(zt.float().numpy(), zj) <= 2**-6


def test_bf16_neumann_apply_casts_in_and_out():
    """K2 takes no bf16: a bf16 r on a float32 plan is applied in float32
    and z rounded back, as JAX's fused_neumann_apply does."""
    A = T.sparse.laplacian_3d(8)
    with rounding_to(BF16):
        L, U = (round_factor(F) for F in t_iluk(round_to(A, BF16), level=0))
    plan = plan_fused_neumann(L, U, 6)
    assert plan.dtype == torch.float32
    r = torch.from_numpy(_x(A.shape[0], 5)).to(BF16)
    z = fused_neumann_apply(plan, r)
    assert z.dtype == BF16
    assert torch.equal(z, fused_neumann_apply(plan, r.float()).to(BF16))
    R = torch.from_numpy(_x(A.shape[0], 6, 3)).to(BF16)
    Z = fused_neumann_apply(plan, R)
    assert Z.dtype == BF16 and torch.equal(Z, fused_neumann_apply(plan, R.float()).to(BF16))
    with pytest.raises(TypeError, match="plan"):
        fused_neumann_apply(plan, r.double())


def _bf16_ref(data, offsets, x, alpha=1.0):
    """α·Σ_d data[d]·shift(x, off_d) in float64 from the bf16 values: the
    exact product the kernel and the plain version round once."""
    n = data.shape[1]
    y = np.zeros((n,) + x.shape[1:])
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, x.shape[0] - off)
        dd = data[d, lo:hi] if x.ndim == 1 else data[d, lo:hi, None]
        y[lo:hi] += dd * x[lo + off:hi + off]
    return alpha * y


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_bf16_dia_plain_matches_jax(alpha, k):
    """K1 / K1k plain in bf16 against JAX's XLA spmv / mv_amxy in bf16, and
    one rounding of the exact sum."""
    Aj, At = J.sparse.laplacian_2d(64), T.sparse.laplacian_2d(64)
    Dj = J.sparse.csr_to_dia(Aj)
    Dj = dataclasses.replace(Dj, data=jnp.asarray(np.asarray(Dj.data), jnp.bfloat16))
    Dt = T.sparse.csr_to_dia(At).to(dtype=BF16)
    x = torch.from_numpy(_x(At.shape[0], 1, k)).to(BF16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if k is None:
        y = mv_amxy(alpha, Dt, x)
        yj = j_amxy(alpha, Dj, xj)
    else:
        y = dia_spmm(Dt, x, alpha)
        yj = jax.vmap(lambda v: j_amxy(alpha, Dj, v), in_axes=1, out_axes=1)(xj)
    assert y.dtype == BF16 and tuple(y.shape) == tuple(x.shape)
    nd = len(Dt.offsets)
    assert _rel(y.float().numpy(), np.asarray(yj, np.float64)) <= nd * 2**-8
    exact = _bf16_ref(Dt.data.double().numpy(), Dt.offsets, x.double().numpy(), alpha)
    assert within_one_ulp(y, exact)
    assert dia_spmv.launches == 0 and dia_spmm.launches == 0


def _nearly_banded(n_side=24, n_extra=60, seed=3):
    rng = np.random.default_rng(seed)
    S = J.sparse.laplacian_2d(n_side).to_scipy().tolil()
    n = S.shape[0]
    for i, j in zip(rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)):
        S[i, j] = S[i, j] + 0.01
    return S.tocsr()


@pytest.mark.parametrize("k", [None, 3])
def test_bf16_hyb_plain_matches_jax(k):
    """K3 / K3k plain in bf16 against JAX's HYB spmv in bf16."""
    S = _nearly_banded()
    Hj = J.sparse.csr_to_hyb(J.sparse.CSR.from_scipy(S))
    Hj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if np.asarray(a).dtype == np.float64 else a, Hj)
    Ht = T.sparse.csr_to_hyb(T.sparse.CSR.from_scipy(S)).to(dtype=BF16)
    assert Ht.nnz_rem > 0
    x = torch.from_numpy(_x(S.shape[0], 2, k)).to(BF16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if k is None:
        y, yj = hyb_spmv(Ht, x), jspmv(jax.device_put(Hj), xj)
    else:
        y = hyb_spmm_plain(Ht, x)
        yj = jax.vmap(lambda v: jspmv(jax.device_put(Hj), v), in_axes=1, out_axes=1)(xj)
    assert y.dtype == BF16
    nd = len(Ht.dia.offsets) + 1
    assert _rel(y.float().numpy(), np.asarray(yj, np.float64)) <= nd * 2**-8
    # one rounding of the exact sum (band and remainder in float64)
    Sb = T.sparse.CSR.from_scipy(S)
    exact = round_to(Sb, BF16).to_scipy().astype(np.float64) @ x.double().numpy()
    assert within_one_ulp(y, np.asarray(exact))


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jsolve.make_mesh(8)


def _jax_dist_spmv(Mj, mesh, x):
    op = jops.make_dist_spmv(Mj, "shards")
    leaves, _ = jax.tree_util.tree_flatten(Mj)
    f = jax.shard_map(lambda *a: op(*[q[0] for q in a[:-1]], a[-1][0])[None], mesh=mesh,
                      in_specs=tuple(P("shards") for _ in range(len(leaves) + 1)),
                      out_specs=P("shards"), check_vma=False)
    return np.asarray(f(*[jnp.asarray(l) for l in leaves],
                        jnp.asarray(x.reshape((8, -1) + x.shape[1:]))),
                      np.float64).reshape(x.shape)


@pytest.mark.parametrize("k", [None, 2])
def test_bf16_dist_product_matches_jax(mesh8, k):
    """K4 / K4k plain in bf16 (the distributed product over 8 shards)
    against JAX's shard_map product in bf16 on mesh8."""
    Aj = J.sparse.convection_diffusion_2d(32, beta=15.0)
    At = T.sparse.convection_diffusion_2d(32, beta=15.0)
    Mj = jpart.partition_matrix(Aj.astype(JBF16), 8, fmt="dia")
    Mt = tpart.partition_matrix(round_to(At, BF16), 8, fmt="dia").to(dtype=BF16)
    x = torch.from_numpy(_x(At.shape[0], 4, k)).to(BF16)
    y = make_dist_spmv(Mt)(x)
    assert y.dtype == BF16 and tuple(y.shape) == tuple(x.shape)
    xj = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    if k is None:
        yj = _jax_dist_spmv(Mj, mesh8, xj)
    else:
        yj = np.stack([_jax_dist_spmv(Mj, mesh8, np.ascontiguousarray(xj[:, c]))
                       for c in range(k)], axis=1)
    nd = len(Mt.offsets)
    assert _rel(y.float().numpy(), yj) <= nd * 2**-8


def test_kernel_dtype_takes_bf16_and_refuses_others():
    t = torch.zeros(2, dtype=BF16)
    assert _kernels.kernel_dtype("x", t) == "bf16"
    with pytest.raises(TypeError, match="float16"):
        _kernels.kernel_dtype("x", t.half())
    with pytest.raises(TypeError, match="bfloat16"):
        _kernels.kernel_dtype("K2 r", t, _kernels.NEUMANN_DTYPES)


@pytest.mark.parametrize("N,jax_nits", [(16, 39), (32, 75)])
def test_bf16_solve_ir_cg_ilu0(N, jax_nits):
    """JAX's tests/test_refine.py bf16 case: cg + ILU(0), inner_rtol 3e-2,
    60 rounds.  JAX's counts (39 at 16³, 75 at 32³) are checked live at
    16³; the port is held to them + 15 % and to JAX's bound 1.1e-8·√n."""
    A = T.sparse.laplacian_3d(N)
    n = A.shape[0]
    kw = dict(method="cg", pc="ilu0", inner_dtype=BF16, inner_rtol=3e-2, max_outer=60,
              options=T.SolverOptions(**O))
    x, info = T.solve_ir(A, torch.ones(n, dtype=torch.float64), **kw)
    if N == 16:
        Aj = J.sparse.laplacian_3d(N)
        _, ij = J.solve_ir(Aj, jnp.ones(n), method="cg", pc="ilu0",
                           inner_dtype=jnp.bfloat16, inner_rtol=3e-2, max_outer=60,
                           options=J.SolverOptions(**O))
        assert int(ij.nits) == jax_nits
    assert info.converged and x.dtype == torch.float64
    assert info.nits <= int(np.ceil(1.15 * jax_nits))
    assert np.linalg.norm(1.0 - A.to_scipy() @ x.numpy()) <= 1.1e-8 * np.sqrt(n)
    # the memo keeps the bf16 and fp32 entries apart
    for dt in (torch.float32, BF16):
        _, _, A32, _, M32 = T.prepare_ir(A, "cg", "ilu0", inner_dtype=dt, device="cpu")
        assert A32.dtype == dt and M32.state[0].vals.dtype == dt


def test_bf16_solve_ir_multi_per_column():
    """solve_ir_multi in bf16, per-column cg (JAX vmaps cg; JAX's blockcg
    cannot run a bf16 carry): each column's inner count against JAX's."""
    Aj, At = J.sparse.laplacian_3d(16), T.sparse.laplacian_3d(16)
    n = At.shape[0]
    B = np.random.default_rng(0).standard_normal((n, 4))
    kw = dict(method="cg", pc="ilu0", inner_rtol=3e-2, max_outer=60)
    _, ij = J.solve_ir_multi(Aj, jnp.asarray(B), inner_dtype=jnp.bfloat16,
                             options=J.SolverOptions(**O), **kw)
    X, it = T.solve_ir_multi(At, torch.from_numpy(B), inner_dtype=BF16,
                             options=T.SolverOptions(**O), **kw)
    jn = np.asarray(ij.nits)
    assert np.all(it.converged)
    assert np.all(it.nits <= np.ceil(1.15 * jn)), (it.nits, jn)
    res = np.linalg.norm(B - At.to_scipy() @ X.numpy(), axis=0)
    assert np.all(res <= 1.1e-8 * np.linalg.norm(B, axis=0))


def test_bf16_dist_solve_ir_bjilu(mesh8):
    """dist_solve_ir in bf16 over 8 shards, cg + block-Jacobi ILU(0) with 6
    Neumann sweeps (the K4 sweeps in bf16), against JAX's mesh8 count."""
    Aj, At = J.sparse.laplacian_3d(16), T.sparse.laplacian_3d(16)
    n = At.shape[0]
    kw = dict(method="cg", pc="bjilu", inner_rtol=3e-2, max_outer=60)
    _, ij = jsolve.dist_solve_ir(Aj, jnp.ones(n), mesh=mesh8, inner_dtype=jnp.bfloat16,
                                 options=J.SolverOptions(**O),
                                 pc_options=J.PCOptions(ilu_sweeps=6), **kw)
    x, it = T.dist_solve_ir(At, torch.ones(n, dtype=torch.float64),
                            mesh=T.make_mesh(8, devices=["cpu"] * 8), inner_dtype=BF16,
                            options=T.SolverOptions(**O),
                            pc_options=T.PCOptions(ilu_sweeps=6), **kw)
    assert it.converged and bool(ij.converged)
    assert it.nits <= int(np.ceil(1.15 * int(ij.nits)))
    assert np.linalg.norm(1.0 - At.to_scipy() @ x.numpy()) <= 1.1e-8 * np.sqrt(n)
