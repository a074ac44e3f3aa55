"""The four CUDA kernels of lssp_tpu_torch and their k-rhs forms on the
card, against their plain PyTorch versions (and each k-rhs form against k
launches of its single-rhs kernel), the AMG applies on the card against the
CPU's, and the entry points' default device.  Every test skips without a CUDA device.  This file
imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are relative to max|ref|: 1e-5 in fp32 and 1e-12 in fp64 (the
kernel fuses multiply-adds and sums in its own order)."""
import dataclasses
import importlib
import os
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu_torch as lt
from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain, dia_spmv, dia_spmv_plain
from lssp_tpu_torch.ops.dia_spmv_ext import (dia_spmm_ext, dia_spmm_ext_plain, dia_spmv_ext,
                                             dia_spmv_ext_plain)
from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain, hyb_spmv, hyb_spmv_plain
from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                        neumann_block_apply, plan_fused_neumann)
from lssp_tpu_torch.pc import base as pc_base
from lssp_tpu_torch.pc.ilu_host import iluk_factor
from lssp_tpu_torch.utils import memo

# the modules (``lssp_tpu_torch.ops`` re-exports functions of the same names)
hyb_mod = importlib.import_module("lssp_tpu_torch.ops.hyb_spmv")
ext_mod = importlib.import_module("lssp_tpu_torch.ops.dia_spmv_ext")
spmv_mod = importlib.import_module("lssp_tpu_torch.ops.spmv")
nm_mod = importlib.import_module("lssp_tpu_torch.ops.neumann")

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen,N", [("laplacian_2d", 37), ("laplacian_3d", 11),
                                   ("convection_diffusion_2d", 50)])
def test_dia_spmv_matches_plain(cuda, gen, N, dtype):
    A = getattr(lt.sparse, gen)(N)
    D = lt.sparse.csr_to_dia(A, device=cuda).to(dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(N)
    x = torch.rand(A.shape[0], generator=g, dtype=dtype).to(cuda)
    z = torch.rand(A.shape[0], generator=g, dtype=dtype).to(cuda)
    before = dia_spmv.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        y = dia_spmv(D, x, alpha=alpha, beta=beta, z=zz)
        ref = dia_spmv_plain(D.data, D.offsets, x, alpha, beta, zz)
        torch.cuda.synchronize()
        assert y.dtype == dtype and _rel(y, ref) <= TOL[dtype]
    assert dia_spmv.launches == before + 3


def test_dia_spmv_rejects_what_it_cannot_take(cuda):
    D = lt.sparse.csr_to_dia(lt.sparse.laplacian_2d(8), device=cuda)
    x = torch.ones(64, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="got torch.float16"):
        dia_spmv(D.to(dtype=torch.float16), x.to(torch.float16))
    with pytest.raises(TypeError, match="dtype"):
        dia_spmv(D, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(D, torch.ones(128, dtype=torch.float64, device=cuda)[::2])
    with pytest.raises(ValueError, match="shape"):
        dia_spmv(D, torch.ones(63, dtype=torch.float64, device=cuda))


def _strayed(n1d, nstray):
    import scipy.sparse as sp
    A = lt.sparse.laplacian_2d(n1d)
    rng = np.random.default_rng(0)
    n = A.shape[0]
    r, c = rng.integers(0, n, nstray), rng.integers(0, n, nstray)
    keep = r != c
    E = sp.coo_matrix((0.1 * rng.standard_normal(keep.sum()), (r[keep], c[keep])),
                      shape=A.shape)
    M = (A.to_scipy() + E.tocsr()).tocsr()
    M.sort_indices()
    return lt.CSR.from_scipy(M)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,sweeps", [("banded", 1), ("banded", 6), ("strayed", 4)])
def test_neumann_apply_matches_plain(cuda, kind, sweeps, dtype):
    A = lt.sparse.laplacian_3d(12) if kind == "banded" else _strayed(45, 300)
    L, U = iluk_factor(A, level=0 if kind == "banded" else 1)
    plan = plan_fused_neumann(L, U, sweeps, dtype=dtype, device=cuda)
    assert (plan.L.stray_ptr is not None or plan.U.stray_ptr is not None) == (kind == "strayed")
    r = torch.from_numpy(np.random.default_rng(sweeps).standard_normal(A.shape[0]))
    r = r.to(device=cuda, dtype=dtype)
    before = fused_neumann_apply.launches
    z = fused_neumann_apply(plan, r)
    ref = neumann_apply_plain(plan, r)
    torch.cuda.synchronize()
    assert _rel(z, ref) <= TOL[dtype]
    assert fused_neumann_apply.launches == before + 1      # the whole apply, one launch


def _adversarial(n1d, seed=0):
    """ILU(0) factors of the 2-D Laplacian's pattern with random values of
    order 1 (unit-order U diagonal), so that the Neumann levels differ by
    O(1) and a value read from the wrong level shows."""
    L, U = iluk_factor(lt.sparse.laplacian_2d(n1d), level=0)
    rng = np.random.default_rng(seed)
    L = dataclasses.replace(L, data=rng.uniform(-1, 1, L.data.shape))   # unit diagonal implied
    ud = rng.uniform(-1, 1, U.data.shape)
    diag = U.indices == np.repeat(np.arange(U.shape[0]), np.diff(U.indptr))
    ud[diag] = np.sign(ud[diag]) + ud[diag]
    return L, dataclasses.replace(U, data=ud)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["adversarial", "ragged", "sweeps_1", "exact_depth"])
def test_neumann_apply_wavefront_cases(cuda, case, dtype):
    """The wavefront's hard cases against the plain version: random O(1)
    band values over 6 sweeps, a ragged n (37³ rows, not a tile multiple),
    one sweep, and the exact depth of ilu_sweeps=-1 (hundreds of levels)."""
    if case == "adversarial":
        (L, U), sweeps = _adversarial(150), 6
    elif case == "ragged":
        (L, U), sweeps = iluk_factor(lt.sparse.laplacian_3d(37), level=0), 6
    elif case == "sweeps_1":
        (L, U), sweeps = iluk_factor(lt.sparse.laplacian_3d(37), level=0), 1
    else:
        M = lt.pc.setup(lt.sparse.laplacian_3d(24).astype(
            np.float32 if dtype == torch.float32 else np.float64), "ilu0",
            lt.PCOptions(ilu_sweeps=-1), device=cuda)
        plan = M.state
        assert plan.sweeps >= 60
    if case != "exact_depth":
        plan = plan_fused_neumann(L, U, sweeps, dtype=dtype, device=cuda)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(plan.n)).to(cuda, dtype)
    before = fused_neumann_apply.launches
    z = fused_neumann_apply(plan, r)
    ref = neumann_apply_plain(plan, r)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all()) and _rel(z, ref) <= TOL[dtype]
    assert fused_neumann_apply.launches == before + 1


def test_neumann_apply_is_deterministic_and_graph_safe(cuda):
    """50 applies of the adversarial plan are bitwise equal (a race would
    differ between runs), and two replays of a CUDA graph that captured
    the apply (memset and launch) give the eager result, for K2 and K2k."""
    L, U = _adversarial(300, seed=1)
    plan = plan_fused_neumann(L, U, 6, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(4)
    for r in (torch.from_numpy(rng.standard_normal(plan.n)).float().to(cuda),
              torch.from_numpy(rng.standard_normal((plan.n, 8))).float().to(cuda)):
        first = fused_neumann_apply(plan, r)
        for _ in range(50):
            assert torch.equal(fused_neumann_apply(plan, r), first)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused_neumann_apply(plan, r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_neumann_apply(plan, r)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)


def _record_case(case, cuda):
    """(plan, r, apply) of a launch-record case: K2 or K2k (k = 2, 8) on
    the 3-D Laplacian 12³'s ILU(0) in fp32 or fp64; an (n, 8) block one
    float off its alignment (kt 1); the transposed plan; a bfloat16 r on a
    float32 plan."""
    dtype = torch.float64 if case.startswith("f64") else torch.float32
    L, U = iluk_factor(lt.sparse.laplacian_3d(12), level=0)
    make = nm_mod.plan_fused_neumann_t if case == "transposed" else plan_fused_neumann
    plan = make(L, U, 6, dtype=dtype, device=cuda)
    k = {"k2": 2, "k8": 8, "misaligned": 8}.get(case.split("_")[-1], None)
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.standard_normal(plan.n if k is None else (plan.n, k)))
    r = r.to(cuda, dtype)
    if case == "misaligned":
        buf = torch.zeros(plan.n * 8 + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(r.reshape(-1))
        r = buf[1:].view(plan.n, 8)
    if case == "bf16":
        r = r.to(torch.bfloat16)
    return plan, r, lambda: fused_neumann_apply(plan, r)


RECORD_CASES = ["f32_k1", "f64_k1", "f32_k2", "f64_k2", "f32_k8", "f64_k8", "misaligned",
                "transposed", "bf16"]


def _host_us(apply, calls=50):
    """Host µs an apply while the card is kept busy, so each launch returns
    at once (a reading, not a bound)."""
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        apply()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


@pytest.mark.parametrize("case", RECORD_CASES)
def test_neumann_launch_record_is_bitwise_a_fresh_launch(cuda, case):
    """An apply through the plan's prepared launch is bitwise the apply
    that prepares it anew (the record cleared), each one launch; the
    record is built once per (k, device, kt) and reused after.  Prints the
    host µs an apply that prepares and one that reuses."""
    plan, r, apply = _record_case(case, cuda)
    k = 1 if r.ndim == 1 else r.shape[1]
    counter = fused_neumann_apply if k == 1 else neumann_block_apply
    before, built = counter.launches, dict(nm_mod.records)
    first, again = apply(), apply()
    assert counter.launches == before + 2
    assert nm_mod.records["built"] == built.get("built", 0) + 1
    assert nm_mod.records["reused"] == built.get("reused", 0) + 1
    (key, rec), = plan._launches.items()
    assert key[:2] == (k, r.device) and rec.kt == (1 if case == "misaligned" else
                                                  {1: 1, 2: 2, 8: 8}[k])
    plan._launches.clear()
    fresh = apply()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, fresh)
    assert counter.launches == before + 3

    def prepared_anew():
        plan._launches.clear()
        apply()
    print(f"\n{case}: host us an apply, preparing {_host_us(prepared_anew):.1f}, "
          f"reusing {_host_us(apply):.1f}")


def test_neumann_apply_rejects_dtype_mismatch(cuda):
    L, U = iluk_factor(lt.sparse.laplacian_2d(8), level=0)
    plan = plan_fused_neumann(L, U, 2, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="plan"):
        fused_neumann_apply(plan, torch.ones(64, dtype=torch.float64, device=cuda))


def test_solve_on_cuda_goes_through_both_kernels(cuda):
    A = lt.sparse.laplacian_3d(16)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    k1, k2 = dia_spmv.launches, fused_neumann_apply.launches
    x, info = lt.solve(A, b.to(cuda), method="cg", pc="ilu0")
    assert info.converged
    assert dia_spmv.launches > k1 and fused_neumann_apply.launches > k2
    xc, ic = lt.solve(A, b, method="cg", pc="ilu0", pc_options=lt.PCOptions(ilu_sweeps=6))
    assert abs(info.nits - ic.nits) <= 1
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-8 * torch.linalg.vector_norm(xc)


def _hyb_case(kind):
    """The K3 cases: the JAX tests' nearly banded Laplacian, the vendored
    coupled3d_25, an empty remainder, a row holding most of the remainder,
    and n = 37² = 1369, not a multiple of the 256-row block."""
    conv = lt.sparse.convert
    if kind == "coupled3d_25":
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "benchmarks", "matrices", "coupled3d_25.mtx.gz")
        return lt.sparse.csr_to_hyb(lt.sparse.read_matrix_market(path))
    n1d = {"nearly_banded": 24, "empty": 20, "heavy_row": 30, "ragged": 37}[kind]
    L = lt.sparse.laplacian_2d(n1d).to_scipy()
    n = L.shape[0]
    rng = np.random.default_rng(3)
    if kind in ("nearly_banded", "ragged"):
        E = sp.coo_matrix((np.full(60, 0.01), (rng.integers(0, n, 60), rng.integers(0, n, 60))),
                          shape=L.shape)
        H = lt.sparse.csr_to_hyb(lt.CSR.from_scipy((L + E).tocsr()))
        assert H.nnz_rem > 0
        return H
    D = lt.sparse.csr_to_dia(lt.CSR.from_scipy(L))
    if kind == "empty":
        return conv.hyb_from_parts(D, [], [], np.zeros(0), L.shape)
    cols = np.arange(0, n, 2)                    # heavy_row: 450 entries in row 517
    rows = np.concatenate([[3], np.full(len(cols), 517), [890]])
    cols = np.concatenate([[800], cols, [5]])
    return conv.hyb_from_parts(D, rows, cols, rng.standard_normal(len(rows)), L.shape)


HYB_KINDS = ["nearly_banded", "coupled3d_25", "empty", "heavy_row", "ragged"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", HYB_KINDS)
def test_hyb_spmv_matches_plain(cuda, kind, dtype):
    H = _hyb_case(kind).to(device=cuda, dtype=dtype)
    n = H.shape[0]
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.rand(n, generator=g, dtype=dtype).to(cuda)
    z = torch.rand(n, generator=g, dtype=dtype).to(cuda)
    before = hyb_spmv.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (1.0, 1.0, z)):
        y = hyb_spmv(H, x, alpha=alpha, beta=beta, z=zz)
        ref = hyb_spmv_plain(H, x, alpha, beta, zz)
        torch.cuda.synchronize()
        assert y.dtype == dtype and _rel(y, ref) <= TOL[dtype]
    assert hyb_spmv.launches == before + 3


def test_hyb_spmv_is_deterministic(cuda):
    H = _hyb_case("coupled3d_25").to(device=cuda, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(H.shape[0])).to(
        device=cuda, dtype=torch.float32)
    assert torch.equal(hyb_spmv(H, x), hyb_spmv(H, x))


def test_hyb_spmv_rejects_what_it_cannot_take(cuda):
    H = _hyb_case("nearly_banded").to(device=cuda)
    x = torch.ones(H.shape[0], dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="got torch.float16"):
        hyb_spmv(H.to(dtype=torch.float16), x.to(torch.float16))
    with pytest.raises(TypeError, match="dtype"):
        hyb_spmv(H, x.float())
    with pytest.raises(ValueError, match="shape"):
        hyb_spmv(H, x[:-1])
    ptr128 = torch.searchsorted(H.rem_rows, torch.arange(0, H.shape[0] + 128, 128,
                                                          dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="rem_block_ptr: shape"):   # built for 128-row blocks
        hyb_spmv(dataclasses.replace(H, rem_block_ptr=ptr128.to(torch.int32)), x)


def test_solve_on_cuda_hyb_goes_through_k3(cuda, monkeypatch):
    """A HYB matrix on the card runs K3 and K2, never the plain product or
    the ELL gather."""
    H = _hyb_case("ragged")
    A = lt.CSR.from_scipy(sp.csr_matrix(H.todense()))
    b = torch.ones(A.shape[0], dtype=torch.float64)
    xc, ic = lt.solve(A, b, method="bicgstab", pc="ilu0",
                      pc_options=lt.PCOptions(ilu_sweeps=6))

    def forbidden(*args, **kw):
        raise AssertionError("plain path taken on a CUDA tensor")
    monkeypatch.setattr(hyb_mod, "hyb_spmv_plain", forbidden)
    monkeypatch.setattr(spmv_mod, "_spmv_ell", forbidden)
    k3, k2 = hyb_spmv.launches, fused_neumann_apply.launches
    x, info = lt.solve(A, b.to(cuda), method="bicgstab", pc="ilu0")
    assert info.converged
    assert hyb_spmv.launches > k3 and fused_neumann_apply.launches > k2
    assert abs(info.nits - ic.nits) <= 1
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-8 * torch.linalg.vector_norm(xc)


def _ext_case(kind, dtype, cuda):
    """K4's cases: (P, ndiag, R) bands with R = 216 (ragged), 256, 625."""
    A, P = {"laplacian_3d_12": (lt.sparse.laplacian_3d(12), 8),
            "laplacian_2d_32": (lt.sparse.laplacian_2d(32), 4),
            "convdiff_50": (lt.sparse.convection_diffusion_2d(50), 4)}[kind]
    return lt.parallel.partition_csr_dia(A, P).to(device=cuda, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["laplacian_3d_12", "laplacian_2d_32", "convdiff_50"])
def test_dia_spmv_ext_matches_plain(cuda, kind, dtype):
    M = _ext_case(kind, dtype, cuda)
    P, R = M.nshards, M.rows_per_shard
    g = torch.Generator(device="cpu").manual_seed(R)
    x_ext = torch.rand(P, R + M.lo + M.hi, generator=g, dtype=dtype).to(cuda)
    z = torch.rand(P, R, generator=g, dtype=dtype).to(cuda)
    before = dia_spmv_ext.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        y = dia_spmv_ext(M.data, M.offsets, x_ext, alpha, beta, zz, offsets_t=M.offsets_t)
        ref = dia_spmv_ext_plain(M.data, M.offsets, x_ext, alpha, beta, zz)
        torch.cuda.synchronize()
        assert y.shape == (P, R) and y.dtype == dtype and _rel(y, ref) <= TOL[dtype]
    assert dia_spmv_ext.launches == before + 3


def test_dia_spmv_ext_rejects_what_it_cannot_take(cuda):
    M = _ext_case("laplacian_2d_32", torch.float64, cuda)
    x_ext = torch.ones(4, 256 + 64, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="got torch.float16"):
        dia_spmv_ext(M.data.to(torch.float16), M.offsets, x_ext.to(torch.float16))
    with pytest.raises(TypeError, match="dtype"):
        dia_spmv_ext(M.data, M.offsets, x_ext.float())
    with pytest.raises(ValueError, match="shape"):
        dia_spmv_ext(M.data, M.offsets, x_ext[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_ext(M.data, M.offsets, torch.ones(4, 640, dtype=torch.float64,
                                                    device=cuda)[:, ::2])


def test_dist_solve_on_cuda_goes_through_k4(cuda, monkeypatch):
    """Eight shards on the card: every DistDIA product and Neumann sweep
    launches K4 (the plain version raises if taken), no other kernel runs,
    and the count matches the CPU port's."""
    A = lt.sparse.laplacian_3d(32)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="cg", pc="ilu0", options=lt.SolverOptions(rtol=1e-8, atol=0))
    cpu_mesh = lt.make_mesh(8, devices=[torch.device("cpu")] * 8)
    xc, ic = lt.dist_solve_ir(A, b, mesh=cpu_mesh, pc_options=lt.PCOptions(ilu_sweeps=6), **kw)

    def forbidden(*args, **kw):
        raise AssertionError("plain path taken on a CUDA tensor")
    monkeypatch.setattr(ext_mod, "dia_spmv_ext_plain", forbidden)
    counts = (dia_spmv.launches, fused_neumann_apply.launches, hyb_spmv.launches,
              dia_spmv_ext.launches)
    x, info = lt.dist_solve_ir(A, b.to(cuda), mesh=lt.make_mesh(8, devices=[cuda] * 8), **kw)
    assert info.converged and x.device.type == "cuda"
    assert (dia_spmv.launches, fused_neumann_apply.launches, hyb_spmv.launches) == counts[:3]
    # per inner iteration: one product and 2 x 6 sweeps
    assert dia_spmv_ext.launches - counts[3] >= 13 * info.nits
    assert abs(info.nits - ic.nits) <= 2
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-6 * torch.linalg.vector_norm(xc)


def test_dist_hyb_solve_on_cuda(cuda):
    H = _hyb_case("nearly_banded")
    A = lt.CSR.from_scipy(sp.csr_matrix(H.todense()))
    b = torch.ones(A.shape[0], dtype=torch.float64)
    # GMRES: BiCGSTAB's count on this small nonsymmetric system moves by 3
    # with the order of the remainder's atomic adds
    kw = dict(method="gmres", pc="jacobi", fmt="hyb",
              options=lt.SolverOptions(rtol=1e-10, atol=0, rbtol=0, maxit=3000))
    xc, ic = lt.dist_solve(A, b, mesh=lt.make_mesh(8, devices=["cpu"] * 8), **kw)
    before = dia_spmv_ext.launches
    x, info = lt.dist_solve(A, b.to(cuda), mesh=lt.make_mesh(8, devices=[cuda] * 8), **kw)
    assert info.converged and dia_spmv_ext.launches > before
    assert abs(info.nits - ic.nits) <= 2
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-6 * torch.linalg.vector_norm(xc)


# ----------------------------------------------------------- the k-rhs forms K1k-K4k

def _cols(Y):
    return [Y[..., c].contiguous() for c in range(Y.shape[-1])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,offset", [(1, 0), (2, 0), (3, 0), (4, 0), (8, 0), (16, 0), (8, 1)])
def test_dia_spmm_matches_plain_and_k1(cuda, k, offset, dtype):
    """Every register-tile width (k = 1, 2, 4, 8 and two tiles of 8; k = 3
    and a block one element off 16-byte alignment take width 1)."""
    A = lt.sparse.convection_diffusion_2d(50)
    D = lt.sparse.csr_to_dia(A, device=cuda).to(dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(k)
    X = torch.rand(A.shape[0] * k + offset, generator=g, dtype=dtype).to(cuda)
    X = X[offset:].view(A.shape[0], k)
    Z = torch.rand(A.shape[0], k, generator=g, dtype=dtype).to(cuda)
    before = (dia_spmm.launches, dia_spmv.launches)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, Z)):
        Y = dia_spmm(D, X, alpha=alpha, beta=beta, Z=zz)
        ref = dia_spmm_plain(D.data, D.offsets, X, alpha, beta, zz)
        singles = [dia_spmv(D, x, alpha, beta, None if zz is None else z)
                   for x, z in zip(_cols(X), _cols(Z))]
        torch.cuda.synchronize()
        assert Y.shape == (A.shape[0], k) and _rel(Y, ref) <= TOL[dtype]
        assert _rel(Y, torch.stack(singles, dim=1)) <= TOL[dtype]
    assert dia_spmm.launches == before[0] + 3 and dia_spmv.launches == before[1] + 3 * k


def test_dia_spmm_rejects_what_it_cannot_take(cuda):
    D = lt.sparse.csr_to_dia(lt.sparse.laplacian_2d(8), device=cuda)
    X = torch.ones(64, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmm(D, torch.ones(4, 64, dtype=torch.float64, device=cuda).T)
    with pytest.raises(ValueError, match="shape"):
        dia_spmm(D, X[:63])
    with pytest.raises(TypeError, match="dtype"):
        dia_spmm(D, X.float())
    with pytest.raises(ValueError, match="block"):
        dia_spmm(D, X[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", HYB_KINDS)
@pytest.mark.parametrize("k", [4, 5, 8])
def test_hyb_spmm_matches_plain_and_k3(cuda, kind, k, dtype):
    H = _hyb_case(kind).to(device=cuda, dtype=dtype)
    n = H.shape[0]
    g = torch.Generator(device="cpu").manual_seed(n)
    X = torch.rand(n, k, generator=g, dtype=dtype).to(cuda)
    Z = torch.rand(n, k, generator=g, dtype=dtype).to(cuda)
    before = hyb_spmm.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (1.0, 1.0, Z)):
        Y = hyb_spmm(H, X, alpha=alpha, beta=beta, Z=zz)
        ref = hyb_spmm_plain(H, X, alpha, beta, zz)
        singles = [hyb_spmv(H, x, alpha, beta, None if zz is None else z)
                   for x, z in zip(_cols(X), _cols(Z))]
        torch.cuda.synchronize()
        assert _rel(Y, ref) <= TOL[dtype] and _rel(Y, torch.stack(singles, 1)) <= TOL[dtype]
    assert hyb_spmm.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,sweeps", [("banded", 1), ("banded", 6), ("strayed", 4)])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_neumann_block_matches_plain_and_k2(cuda, kind, sweeps, k, dtype):
    A = lt.sparse.laplacian_3d(12) if kind == "banded" else _strayed(45, 300)
    L, U = iluk_factor(A, level=0 if kind == "banded" else 1)
    plan = plan_fused_neumann(L, U, sweeps, dtype=dtype, device=cuda)
    R = torch.from_numpy(np.random.default_rng(sweeps).standard_normal((A.shape[0], k)))
    R = R.to(device=cuda, dtype=dtype)
    before = (neumann_block_apply.launches, fused_neumann_apply.launches)
    Z = fused_neumann_apply(plan, R)                  # a block goes to K2k
    assert (neumann_block_apply.launches, fused_neumann_apply.launches) == \
        (before[0] + 1, before[1])
    ref = neumann_apply_plain(plan, R)
    singles = torch.stack([fused_neumann_apply(plan, r) for r in _cols(R)], 1)
    torch.cuda.synchronize()
    assert _rel(Z, ref) <= TOL[dtype] and _rel(Z, singles) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["laplacian_3d_12", "convdiff_50"])
@pytest.mark.parametrize("k", [3, 8])
def test_dia_spmm_ext_matches_plain_and_k4(cuda, kind, k, dtype):
    M = _ext_case(kind, dtype, cuda)
    P, R = M.nshards, M.rows_per_shard
    g = torch.Generator(device="cpu").manual_seed(R)
    x_ext = torch.rand(P, R + M.lo + M.hi, k, generator=g, dtype=dtype).to(cuda)
    z = torch.rand(P, R, k, generator=g, dtype=dtype).to(cuda)
    before = dia_spmm_ext.launches
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, z)):
        y = dia_spmm_ext(M.data, M.offsets, x_ext, alpha, beta, zz, offsets_t=M.offsets_t)
        ref = dia_spmm_ext_plain(M.data, M.offsets, x_ext, alpha, beta, zz)
        singles = [dia_spmv_ext(M.data, M.offsets, x, alpha, beta, None if zz is None else zc,
                                offsets_t=M.offsets_t) for x, zc in zip(_cols(x_ext), _cols(z))]
        torch.cuda.synchronize()
        assert y.shape == (P, R, k) and _rel(y, ref) <= TOL[dtype]
        assert _rel(y, torch.stack(singles, -1)) <= TOL[dtype]
    assert dia_spmm_ext.launches == before + 2


def _counts():
    return dict(k1=dia_spmv.launches, k2=fused_neumann_apply.launches, k3=hyb_spmv.launches,
                k4=dia_spmv_ext.launches, k1k=dia_spmm.launches,
                k2k=neumann_block_apply.launches, k3k=hyb_spmm.launches,
                k4k=dia_spmm_ext.launches)


def _moved(before):
    return {name: n - before[name] for name, n in _counts().items() if n != before[name]}


def test_solve_ir_multi_on_cuda_launches_only_k_rhs_forms(cuda):
    """blockcg + ILU(0) on 16³, k = 4: K1k and K2k run, K1-K4 never; the
    result matches the CPU port's."""
    A = lt.sparse.laplacian_3d(16)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal((A.shape[0], 4)))
    kw = dict(method="blockcg", pc="ilu0", options=lt.SolverOptions(rtol=1e-8, atol=0))
    Xc, ic = lt.solve_ir_multi(A, B, pc_options=lt.PCOptions(ilu_sweeps=6), **kw)
    before = _counts()
    X, info = lt.solve_ir_multi(A, B.to(cuda), **kw)
    moved = _moved(before)
    assert info.converged.all() and set(moved) == {"k1k", "k2k"}, moved
    assert (np.abs(info.nits - ic.nits) <= 2).all()
    assert torch.linalg.vector_norm(X.cpu() - Xc) <= 1e-6 * torch.linalg.vector_norm(Xc)


def test_solve_multi_hyb_on_cuda_goes_through_k3k(cuda, monkeypatch):
    H = _hyb_case("ragged")
    A = lt.CSR.from_scipy(sp.csr_matrix(H.todense()))
    B = torch.from_numpy(np.random.default_rng(1).standard_normal((A.shape[0], 3)))

    def forbidden(*args, **kw):
        raise AssertionError("plain path taken on a CUDA tensor")
    monkeypatch.setattr(hyb_mod, "hyb_spmm_plain", forbidden)
    before = _counts()
    X, info = lt.solve_ir_multi(A, B.to(cuda), method="blockgmres", pc="iluk",
                                options=lt.SolverOptions(rtol=1e-8, atol=0))
    moved = _moved(before)
    assert info.converged.all() and set(moved) == {"k3k", "k2k"}, moved


def test_dist_solve_ir_multi_on_cuda_launches_only_k4k(cuda):
    A = lt.sparse.laplacian_3d(16)
    B = torch.from_numpy(np.random.default_rng(2).standard_normal((A.shape[0], 3)))
    kw = dict(method="blockcg", pc="ilu0", options=lt.SolverOptions(rtol=1e-8, atol=0))
    Xc, ic = lt.dist_solve_ir_multi(A, B, mesh=lt.make_mesh(8, devices=["cpu"] * 8),
                                    pc_options=lt.PCOptions(ilu_sweeps=6), **kw)
    before = _counts()
    X, info = lt.dist_solve_ir_multi(A, B.to(cuda), mesh=lt.make_mesh(8, devices=[cuda] * 8),
                                     **kw)
    moved = _moved(before)
    assert info.converged.all() and set(moved) == {"k4k"}, moved
    assert (np.abs(info.nits - ic.nits) <= 2).all()
    assert torch.linalg.vector_norm(X.cpu() - Xc) <= 1e-6 * torch.linalg.vector_norm(Xc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pc,gen,N", [("saamg", "anisotropic_poisson_2d", 40),
                                      ("rsamg", "laplacian_3d", 12),
                                      ("amg", "anisotropic_poisson_2d", 40)])
def test_amg_apply_on_the_card_matches_cpu(cuda, pc, gen, N, dtype):
    """One AMG apply built from the same host matrix on the card (K1 on DIA
    levels, K3 on HYB ones) and on the CPU (plain versions), on a vector and
    an (n, 3) block."""
    A = getattr(lt.sparse, gen)(N)
    A = A.astype({torch.float32: np.float32, torch.float64: np.float64}[dtype])
    Mc, Mg = lt.pc.setup(A, pc, device="cpu"), lt.pc.setup(A, pc, device=cuda)
    rng = np.random.default_rng(N)
    r = torch.from_numpy(rng.standard_normal(A.shape[0])).to(dtype)
    R = torch.from_numpy(rng.standard_normal((A.shape[0], 3))).to(dtype)
    before = dia_spmv.launches + dia_spmm.launches
    z, Z = Mg(r.to(cuda)), Mg(R.to(cuda))
    torch.cuda.synchronize()
    assert dia_spmv.launches + dia_spmm.launches > before
    assert _rel(z.cpu(), Mc(r)) <= 10 * TOL[dtype]
    assert _rel(Z.cpu(), Mc(R)) <= 10 * TOL[dtype]


def _applies_moved(before):
    return {k: v - before.get(k, 0) for k, v in pc_base.applies.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("k", [None, 8])
def test_saamg_graph_replay_is_the_eager_apply(cuda, k):
    """saamg on the anisotropic Poisson 256² (fp32): the first apply of a
    shape captures a CUDA graph, every later one replays it; each result
    is bitwise the eager ``apply_fn(state, r)`` and a tensor of its own, so
    a later apply leaves an earlier result as it was."""
    A = lt.sparse.anisotropic_poisson_2d(256, epsilon=0.01).astype(np.float32)
    M = lt.pc.setup(A, "saamg", device=cuda)
    rng = np.random.default_rng(7)
    shape = (A.shape[0],) if k is None else (A.shape[0], k)
    rs = [torch.from_numpy(rng.standard_normal(shape)).float().to(cuda) for _ in range(3)]
    before = dict(pc_base.applies)
    zs = [M(rs[0])]
    assert _applies_moved(before) == {"capture": 1}
    zs += [M(r) for r in rs[1:]]
    assert _applies_moved(before) == {"capture": 1, "replay": 2}
    for r, z in zip(rs, zs):
        assert torch.equal(z, M.apply_fn(M.state, r))
    assert len({z.data_ptr() for z in zs}) == 3


# every kernel wrapper's launch counter
WRAPPERS = (dia_spmv, dia_spmm, dia_spmv_ext, dia_spmm_ext, hyb_spmv, hyb_spmm,
            fused_neumann_apply, neumann_block_apply)


def _launch_counts():
    return {fn.__name__: (fn.launches, dict(fn.by_dtype), dict(getattr(fn, "by_route", {})))
            for fn in WRAPPERS}


def _launches_moved(before):
    moved = {}
    for name, (n, dt, rt) in _launch_counts().items():
        n0, dt0, rt0 = before[name]
        if n != n0:
            moved[name] = (n - n0, {k: v - dt0.get(k, 0) for k, v in dt.items() if v != dt0.get(k, 0)},
                           {k: v - rt0.get(k, 0) for k, v in rt.items() if v != rt0.get(k, 0)})
    return moved


def _times(moved, m):
    return {name: (n * m, {k: v * m for k, v in dt.items()}, {k: v * m for k, v in rt.items()})
            for name, (n, dt, rt) in moved.items()}


@pytest.mark.parametrize("k", [None, 8])
def test_saamg_replays_count_the_launches_of_the_eager_apply(cuda, k):
    """The kernel wrappers count what runs: a replay counts the launches
    of one eager apply (by dtype and route), N replays N times as many;
    the capturing apply counts its eager warm-up and its replay, and the
    capture itself, which launches nothing, no launch."""
    A = lt.sparse.anisotropic_poisson_2d(256, epsilon=0.01).astype(np.float32)
    M = lt.pc.setup(A, "saamg", device=cuda)
    shape = (A.shape[0],) if k is None else (A.shape[0], k)
    r = torch.from_numpy(np.random.default_rng(11).standard_normal(shape)).float().to(cuda)
    before = _launch_counts()
    M.apply_fn(M.state, r)
    eager = _launches_moved(before)
    assert eager and ("dia_spmv" if k is None else "dia_spmm") in eager
    before = _launch_counts()
    M(r)
    assert _launches_moved(before) == _times(eager, 2)
    before = _launch_counts()
    for _ in range(5):
        M(r)
    assert _launches_moved(before) == _times(eager, 5)


def test_saamg_applies_on_two_streams_keep_apart(cuda):
    """One saamg instance applied on two streams, each to its own r, with
    no sync between them: each stream replays a graph of its own, and
    every result is bitwise the eager apply of its own r."""
    A = lt.sparse.anisotropic_poisson_2d(256, epsilon=0.01).astype(np.float32)
    M = lt.pc.setup(A, "saamg", device=cuda)
    rng = np.random.default_rng(12)
    rs = [torch.from_numpy(rng.standard_normal(A.shape[0])).float().to(cuda) for _ in range(2)]
    want = [M.apply_fn(M.state, r) for r in rs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    zs = [[], []]
    for _ in range(6):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                zs[i].append(M(rs[i]))
    torch.cuda.synchronize()
    assert len({key[3] for key in M._graphs}) == 2
    for i in range(2):
        assert all(torch.equal(z, want[i]) for z in zs[i])


@pytest.mark.parametrize("where", ["nan_guard", "capture"])
def test_saamg_apply_runs_eagerly_where_a_graph_cannot_hold_it(cuda, where):
    """Under ``nan_guard`` every kernel's output is read back, a host sync
    a graph cannot hold; inside a caller's own capture a second capture
    cannot begin.  The saamg apply runs eagerly in both, and the caller's
    graph replays it bitwise."""
    A = lt.sparse.anisotropic_poisson_2d(64, epsilon=0.01).astype(np.float32)
    M = lt.pc.setup(A, "saamg", device=cuda)
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(A.shape[0])).float().to(cuda)
    eager = M.apply_fn(M.state, r)
    before = dict(pc_base.applies)
    if where == "nan_guard":
        with lt.utils.nan_guard():
            z = M(r)
    else:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            M.apply_fn(M.state, r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z = M(r)
        graph.replay()
        torch.cuda.synchronize()
    assert _applies_moved(before) == {"eager": 1} and not M._graphs
    assert torch.equal(z, eager)


def test_solve_ir_saamg_graph_matches_the_eager_solve(cuda):
    """solve_ir GMRES(30) + saamg on the anisotropic Poisson 256²: the
    solve whose PC replays graphs gives the counts and, bitwise, the x of
    the same solve with that PC rebuilt with ``graph_safe`` off."""
    A = lt.sparse.anisotropic_poisson_2d(256, epsilon=0.01)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(A.shape[0])).to(cuda)
    kw = dict(method="gmres", pc="saamg",
              options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, restart=30))
    before = dict(pc_base.applies)
    x1, i1 = lt.solve_ir(A, b, **kw)
    moved = _applies_moved(before)
    assert moved["capture"] == 1 and set(moved) == {"capture", "replay"}, moved
    key, = [key for key in A._prepared_cache if key[0] == "ir-pc"]
    M = A._prepared_cache[key]
    A._prepared_cache[key] = dataclasses.replace(M, graph_safe=False)
    before = dict(pc_base.applies)
    x2, i2 = lt.solve_ir(A, b, **kw)
    assert set(_applies_moved(before)) == {"eager"}
    assert i1.converged and i1.nits == i2.nits and i1.residual == i2.residual
    assert torch.equal(x1, x2)


def test_one_card_one_memo_entry(cuda):
    """device="cuda" and the default (host data) share one prepared
    matrix; a mesh of "cuda" and "cuda:0" slots is one device."""
    A = lt.sparse.laplacian_3d(8)
    b = np.ones(A.shape[0])
    lt.solve(A, b, method="cg", pc="ilu0", device="cuda")
    lt.solve(A, b, method="cg", pc="ilu0")
    keys = [k for k in A._prepared_cache if k[0] == "prepared"]
    assert keys == [("prepared", "auto", f"cuda:{torch.cuda.current_device()}")], keys
    lt.prepare_ir(A, method="cg", pc="ilu0", device="cuda")
    lt.prepare_ir(A, method="cg", pc="ilu0")
    assert len([k for k in A._prepared_cache if k[0] == "ir-mat"]) == 1
    mesh = lt.make_mesh(devices=["cuda", "cuda:0"])
    assert mesh.size == 2 and len(set(mesh.devices)) == 1
    x, info = lt.dist_solve(A, b, method="cg", pc="jacobi", mesh=mesh)
    assert info.converged and x.device == mesh.device


def test_solve_ir_memo_hits_bitwise_and_sees_inplace_changes(cuda):
    """solve_ir CG + ILU(0) at 64³ twice on one container: the second call
    hits every memo entry and gives x bitwise.  An in-place change of one
    value, then of one ``indptr`` entry, makes the entries stale, and the
    answer is the one a fresh container of the changed arrays gives."""
    N = 64
    A0 = lt.sparse.laplacian_3d(N)
    # row k starts with a stored zero (column k − N² − 2, outside row k − 1's
    # pattern), so moving indptr[k] hands it to row k − 1 and the values stay
    k = N * N + 5
    ip, ix, v = A0.indptr.copy(), A0.indices.copy(), A0.data.copy()
    ix, v = np.insert(ix, ip[k], k - N * N - 2), np.insert(v, ip[k], 0.0)
    ip[k + 1:] += 1
    A = type(A0)(ip, ix, v, A0.shape)
    b = torch.from_numpy(np.random.default_rng(21).standard_normal(A.shape[0])).to(cuda)
    kw = dict(method="cg", pc="ilu0", options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0))

    def solve(M):
        before = dict(memo.lookups)
        x, info = lt.solve_ir(M, b, **kw)
        assert info.converged and x.is_cuda
        return x, {o: memo.lookups[o] - before.get(o, 0) for o in ("hit", "miss", "stale")}

    x1, _ = solve(A)
    x2, moved = solve(A)
    assert moved["hit"] > 0 and moved["miss"] == moved["stale"] == 0, moved
    assert torch.equal(x1, x2)
    for change in ("value", "indptr"):
        if change == "value":
            A.data[A.indptr[7] + np.flatnonzero(A.indices[A.indptr[7]:A.indptr[8]] == 7)[0]] += 1.0
        else:
            A.indptr[k] += 1
        x, moved = solve(A)
        assert moved["stale"] > 0 and moved["hit"] == 0, (change, moved)
        xf, _ = solve(type(A)(A.indptr.copy(), A.indices.copy(), A.data.copy(), A.shape))
        assert torch.equal(x, xf), change
        S = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
        bh = b.cpu().numpy()
        assert np.linalg.norm(bh - S @ x.cpu().numpy()) <= 1e-8 * np.linalg.norm(bh), change
    assert not torch.equal(x, x1)


def test_entry_points_default_to_the_card(cuda):
    A = lt.sparse.anisotropic_poisson_2d(48, epsilon=0.01)
    x, info = lt.solve_ir(A, np.ones(A.shape[0]), method="gmres", pc="saamg",
                          options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, restart=30))
    assert x.device.type == "cuda" and info.converged
    assert lt.make_mesh().device.type == "cuda"
    x, out = lt.amg_solve(A, np.ones(A.shape[0]), rtol=1e-8, atol=0.0)
    assert x.device.type == "cuda" and out["residual"] <= 1e-8 * 48 * 10


KRYLOV = ["cgs", "cr", "crs", "bicrstab", "bicgsafe", "bicrsafe", "gpbicg", "gpbicr",
          "qmrcgstab", "tfqmr", "orthomin", "bicgstabl", "idrs", "lgmres", "rlgmres", "minres",
          "fgmres"]


@pytest.mark.parametrize("method", KRYLOV)
def test_krylov_method_on_cuda_runs_k1_and_k2_only(cuda, method):
    """A 32³ solve + ILU(0) on the card launches K1 and K2 and no other
    kernel, converges, and takes the CPU's count (6 sweeps there too) ±2."""
    A = lt.sparse.laplacian_3d(32)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext, dia_spmm,
                neumann_block_apply, hyb_spmm, dia_spmm_ext)
    before = [fn.launches for fn in counters]
    x, info = lt.solve(A, b.to(cuda), method=method, pc="ilu0")
    torch.cuda.synchronize()
    moved = {fn.__name__ for fn, c in zip(counters, before) if fn.launches != c}
    assert moved == {"dia_spmv", "fused_neumann_apply"}, moved
    assert info.converged and x.device.type == "cuda"
    xc, ic = lt.solve(A, b, method=method, pc="ilu0", pc_options=lt.PCOptions(ilu_sweeps=6))
    assert abs(info.nits - ic.nits) <= 2, (info.nits, ic.nits)
    res = np.linalg.norm(b.numpy() - A.to_scipy() @ x.cpu().numpy())
    assert res <= 1e-6 * np.linalg.norm(b.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_idrs_shadow_space_on_cuda_is_the_cpu_draw(cuda, dtype):
    """IDR(s)'s P drawn on the card equals the CPU draw (which equals JAX's,
    ``tests/test_torch_krylov_common.py``) bitwise, and after MGS to
    rounding."""
    from lssp_tpu_torch.solvers import _threefry
    from lssp_tpu_torch.solvers.idrs import shadow_space
    for s, n in ((4, 4097), (8, 262144)):
        assert torch.equal(_threefry.uniform((s, n), dtype, cuda).cpu(),
                           _threefry.uniform((s, n), dtype))
        P = shadow_space(s, n, dtype, cuda).cpu()
        assert _rel(P, shadow_space(s, n, dtype, "cpu")) <= 100 * TOL[dtype]


def test_bsr_solve_on_cuda_launches_only_k1(cuda):
    """A BSR (elasticity, 2×2 blocks) prepares scalar DIA: ``solve_ir`` with
    the block ILU runs K1 and no other kernel (its apply is BDIA products,
    plain torch), and takes the CPU's count (6 sweeps there too) ±2."""
    A = lt.sparse.csr_to_bsr(lt.sparse.elasticity_2d(32), 2)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="bicgstabl", pc="biluk", options=lt.SolverOptions(rtol=1e-8, atol=0))
    xc, ic = lt.solve_ir(A, b, pc_options=lt.PCOptions(block_size=2, ilu_sweeps=6), **kw)
    before = _counts()
    x, info = lt.solve_ir(A, b.to(cuda), pc_options=lt.PCOptions(block_size=2), **kw)
    moved = _moved(before)
    assert info.converged and set(moved) == {"k1"}, moved
    assert abs(info.nits - ic.nits) <= max(2, int(0.15 * ic.nits)), (info.nits, ic.nits)
    res = np.linalg.norm(b.numpy() - A.to_scipy() @ x.cpu().numpy())
    assert res <= 1e-8 * np.linalg.norm(b.numpy())


def test_bsr_multi_on_cuda_launches_only_k1k(cuda):
    A = lt.sparse.csr_to_bsr(lt.sparse.elasticity_2d(24), 2)
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((A.shape[0], 4)))
    before = _counts()
    X, info = lt.solve_ir_multi(A, B.to(cuda), method="blockcg", pc="biluk",
                                options=lt.SolverOptions(rtol=1e-8, atol=0),
                                pc_options=lt.PCOptions(block_size=2))
    moved = _moved(before)
    assert info.converged.all() and set(moved) == {"k1k"}, moved


@pytest.mark.parametrize("pc", ["saamg", "rsamg"])
def test_dist_amg_on_cuda_launches_only_k4(cuda, pc, monkeypatch):
    """Distributed saamg / rsamg over 8 shards of the card: every level
    product is K4 (the plain version raises if taken), and the count is
    the CPU mesh's ±2."""
    A = lt.sparse.anisotropic_poisson_2d(64, epsilon=0.01) if pc == "saamg" \
        else lt.sparse.laplacian_3d(16)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(method="cg", pc=pc, options=lt.SolverOptions(rtol=1e-8, atol=0, maxit=200))
    xc, ic = lt.dist_solve(A, b, mesh=lt.make_mesh(8, devices=["cpu"] * 8), **kw)

    def forbidden(*args, **kw):
        raise AssertionError("plain path taken on a CUDA tensor")
    monkeypatch.setattr(ext_mod, "dia_spmv_ext_plain", forbidden)
    before = _counts()
    x, info = lt.dist_solve(A, b.to(cuda), mesh=lt.make_mesh(8, devices=[cuda] * 8), **kw)
    moved = _moved(before)
    assert info.converged and set(moved) == {"k4"}, moved
    assert abs(info.nits - ic.nits) <= 2
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-8 * torch.linalg.vector_norm(xc)


@pytest.mark.parametrize("pc,kw", [("biluk", dict(block_size=2)), ("bilut", dict(block_size=2)),
                                   ("vbiluk", dict(block_sizes=[2] * 576)),
                                   ("vbilut", dict(block_sizes=[4] * 288))])
def test_block_pcs_on_cuda_match_cpu(cuda, pc, kw):
    """``solve`` on a BSR with each block-ILU name on the card (6 sweeps over
    BDIA factors): K1 alone among the kernels, the CPU's count (6 sweeps
    there too) ±2, x to 1e-8."""
    A = lt.sparse.csr_to_bsr(lt.sparse.elasticity_2d(24), 2)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    o = lt.SolverOptions(maxit=2000, restart=60)
    xc, ic = lt.solve(A, b, method="gmres", pc=pc, options=o,
                      pc_options=lt.PCOptions(ilu_sweeps=6, **kw))
    before = _counts()
    x, info = lt.solve(A, b.to(cuda), method="gmres", pc=pc, options=o,
                       pc_options=lt.PCOptions(**kw))
    moved = _moved(before)
    assert info.converged and set(moved) == {"k1"}, moved
    assert abs(info.nits - ic.nits) <= 2, (info.nits, ic.nits)
    assert torch.linalg.vector_norm(x.cpu() - xc) <= 1e-8 * torch.linalg.vector_norm(xc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("level", [0, 1])
def test_transposed_plan_on_cuda_matches_plain(cuda, level, dtype):
    """K2 and K2k on the transposed plan (M⁻ᵀ) against its plain version,
    one launch an apply."""
    from lssp_tpu_torch.ops.neumann import plan_fused_neumann_t
    A = lt.sparse.convection_diffusion_2d(40, beta=10.0)
    L, U = iluk_factor(A, level=level)
    plan = plan_fused_neumann_t(L, U, 6, dtype=dtype, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(level)
    r = torch.rand(A.shape[0], generator=g, dtype=dtype).to(cuda)
    R = torch.rand(A.shape[0], 4, generator=g, dtype=dtype).to(cuda)
    before = (fused_neumann_apply.launches, neumann_block_apply.launches)
    assert _rel(fused_neumann_apply(plan, r), neumann_apply_plain(plan, r)) <= TOL[dtype]
    assert _rel(neumann_block_apply(plan, R), neumann_apply_plain(plan, R)) <= TOL[dtype]
    assert (fused_neumann_apply.launches, neumann_block_apply.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("method,pc", [("bicg", "ssor"), ("qmr", "ilu0"), ("cgnr", "ilu0"),
                                       ("lsqr", "iluk")])
def test_transpose_solve_ir_on_cuda(cuda, method, pc):
    """solve_ir with a transpose method on the card: K2 runs both M⁻¹ and
    M⁻ᵀ, only K1 and K2 launch, and the count is within 15 % of the CPU's
    (same 6 sweeps)."""
    A = lt.sparse.convection_diffusion_2d(48, beta=10.0)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    o = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0)
    pco = lt.PCOptions(ilu_sweeps=6)
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext)
    for fn in counters:
        fn.launches = 0
    x, info = lt.solve_ir(A, b.to(cuda), method=method, pc=pc, options=o, pc_options=pco)
    launches = {fn.__name__: fn.launches for fn in counters}
    _, ref = lt.solve_ir(A, b, method=method, pc=pc, options=o, pc_options=pco)
    assert info.converged and abs(info.nits - ref.nits) <= max(2, 0.15 * ref.nits)
    assert launches["dia_spmv"] > 0 and launches["fused_neumann_apply"] >= 2 * info.nits
    assert launches["hyb_spmv"] == launches["dia_spmv_ext"] == 0
    assert np.linalg.norm(b.numpy() - A.to_scipy() @ x.cpu().numpy()) <= 1e-8 * 48 * 1.01


def test_tall_lsqr_on_cuda_runs_k3(cuda):
    """lsqr on the tall [L; 0.1·I] runs its forward product on K3 (HYB)
    and gives the least-squares answer."""
    L = lt.sparse.laplacian_2d(64).to_scipy()
    S = sp.vstack([L, 0.1 * sp.eye(L.shape[0])]).tocsr()
    A = lt.CSR.from_scipy(S)
    b = torch.from_numpy(S @ np.ones(S.shape[1])).to(cuda)
    before = hyb_spmv.launches
    x, info = lt.solve(A, b, method="lsqr",
                       options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=5000))
    r = S @ np.ones(S.shape[1]) - S @ x.cpu().numpy()
    assert info.converged and hyb_spmv.launches - before >= info.nits
    assert np.linalg.norm(S.T @ r) <= 1e-6 * np.linalg.norm(S.T @ (S @ np.ones(S.shape[1])))


def test_dist_transpose_on_cuda_launches_only_k4(cuda):
    """dist_solve_ir bicg + bjilu over 8 shards of the card: the forward
    product and both sweeps (M⁻¹, and M⁻ᵀ on the transposed bands) run K4."""
    A = lt.sparse.laplacian_3d(16)
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext)
    for fn in counters:
        fn.launches = 0
    x, info = lt.dist_solve_ir(A, torch.ones(A.shape[0], dtype=torch.float64, device=cuda),
                               method="bicg", pc="bjilu",
                               mesh=lt.make_mesh(8, devices=[cuda] * 8),
                               options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0))
    assert info.converged and dia_spmv_ext.launches >= 25 * info.nits
    assert dia_spmv.launches == fused_neumann_apply.launches == hyb_spmv.launches == 0


def _one_ulp(y, ref):
    """bf16 y within one bf16 ulp (2⁻⁷ relative) of its plain version, over
    the entries with |ref| ≥ 1e-3·max|ref|."""
    y, ref = y.double(), ref.double()
    keep = ref.abs() >= 1e-3 * ref.abs().max()
    return bool(((y - ref).abs()[keep] <= 2**-7 * ref.abs()[keep]).all())


@pytest.mark.parametrize("k", [None, 8])
def test_bf16_kernels_match_plain(cuda, k):
    """K1 / K3 / K4 (k = None) and K1k / K3k / K4k (k = 8) in bfloat16: bf16
    loads, float32 sums and epilogue, one rounding; within one bf16 ulp of
    the plain versions, which round the same float32 sum once."""
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(11)

    def rnd(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float32).to(cuda, bf)
    shape = () if k is None else (k,)
    D = lt.sparse.csr_to_dia(lt.sparse.laplacian_3d(11), device=cuda).to(dtype=bf)
    H = _hyb_case("nearly_banded").to(device=cuda, dtype=bf)
    M = _ext_case("laplacian_2d_32", torch.float32, cuda)
    Md = M.data.to(bf)
    P, R = M.nshards, M.rows_per_shard
    for alpha, beta, with_z in ((1.0, 0.0, False), (0.25, 0.0, False), (-1.0, 1.0, True)):
        x, z = rnd(D.shape[0], *shape), rnd(D.shape[0], *shape)
        zz = z if with_z else None
        fn, plain = (dia_spmv, dia_spmv_plain) if k is None else (dia_spmm, dia_spmm_plain)
        y = fn(D, x, alpha, beta, zz)
        assert y.dtype == bf and _one_ulp(y, plain(D.data, D.offsets, x, alpha, beta, zz))
        x, z = rnd(H.shape[0], *shape), rnd(H.shape[0], *shape)
        zz = z if with_z else None
        fn, plain = (hyb_spmv, hyb_spmv_plain) if k is None else (hyb_spmm, hyb_spmm_plain)
        y = fn(H, x, alpha, beta, zz)
        assert y.dtype == bf and _one_ulp(y, plain(H, x, alpha, beta, zz))
        x_ext, z = rnd(P, R + M.lo + M.hi, *shape), rnd(P, R, *shape)
        zz = z if with_z else None
        fn, plain = ((dia_spmv_ext, dia_spmv_ext_plain) if k is None
                     else (dia_spmm_ext, dia_spmm_ext_plain))
        y = fn(Md, M.offsets, x_ext, alpha, beta, zz)
        assert y.dtype == bf and _one_ulp(y, plain(Md, M.offsets, x_ext, alpha, beta, zz))


# The band ring (csrc/band_ring.cuh): K1 / K3 in bf16 on the shapes the host
# plan sends to it.  Its y is the rowwise kernel's bit for bit (the same
# fused multiply-adds in the same order, one rounding), and so within one
# bf16 ulp of the plain versions.

RING_PINS = [None, (2048, 2), (1024, 4), (512, 3)]


def _ring_band(n, ncols, offsets, seed):
    """A DIA of random bf16 values (zeros where i + off_d leaves [0, ncols))."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1, 1, (len(offsets), n))
    for d, off in enumerate(offsets):
        j = np.arange(n) + off
        data[d, (j < 0) | (j >= ncols)] = 0.0
    return lt.DIA(tuple(offsets), torch.from_numpy(data).to(torch.bfloat16), (n, ncols))


RING_BANDS = {
    "lap2d_512": (512 * 512, 512 * 512, (-512, -1, 0, 1, 512)),
    "lap3d_32": (32 ** 3, 32 ** 3, (-1024, -32, -1, 0, 1, 32, 1024)),
    "past_both_ends": (1024, 1024, (-1500, -13, 0, 6, 1201)),
    "tall": (8192, 4096, (-4096, -4095, 0, 3)),
    "wide": (4096, 8200, (0, 5, 4099, 8196)),
    "partial_tile": (10000, 10000, (-71, -1, 0, 1, 71)),
}


def _ring_plan(shape, offsets, has_z, pin, rem=False):
    from lssp_tpu_torch.ops.dia_spmv import band_tile_plan
    kw = {} if pin is None else dict(T=pin[0], S=pin[1])
    plan = band_tile_plan(shape[0], shape[1], tuple(offsets), 2, has_z, rem,
                          num_sms=torch.cuda.get_device_properties(0).multi_processor_count,
                          **kw)
    assert plan.route == "ring", plan.reason
    return plan


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("pin", RING_PINS, ids=lambda p: "plan" if p is None else f"T{p[0]}S{p[1]}")
@pytest.mark.parametrize("name", list(RING_BANDS))
def test_ring_k1_equals_rowwise_bitwise(cuda, name, pin):
    from lssp_tpu_torch.ops.dia_spmv import ROWWISE
    n, ncols, offs = RING_BANDS[name]
    D = _ring_band(n, ncols, offs, seed=n).to(device=cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    x = (torch.rand(ncols, generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    z = (torch.rand(n, generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        plan = _ring_plan(D.shape, offs, zz is not None, pin)
        before = dict(dia_spmv.by_route)
        y = dia_spmv(D, x, alpha, beta, zz, plan=plan)
        ref = dia_spmv(D, x, alpha, beta, zz, plan=ROWWISE)
        torch.cuda.synchronize()
        assert dia_spmv.by_route["ring"] == before.get("ring", 0) + 1
        assert dia_spmv.by_route["rowwise"] == before.get("rowwise", 0) + 1
        assert _bits_equal(y, ref), (y.float() - ref.float()).abs().max().item()
        assert _one_ulp(y, dia_spmv_plain(D.data, D.offsets, x, alpha, beta, zz))
        # the wrapper's own plan takes the ring too, and repeats bitwise
        assert _bits_equal(dia_spmv(D, x, alpha, beta, zz), y)


def _ring_hyb(kind, cuda):
    """K3 ring cases on a 2-D Laplacian 128² band (16,384 rows; 10,000 for
    the last partial tile): an empty remainder, random strays, a tile
    whose slice spans several shared chunks, a row with 600 entries."""
    rng = np.random.default_rng(7)
    n = 10000 if kind == "partial_tile" else 128 * 128
    offs = (-128, -1, 0, 1, 128)
    D = _ring_band(n, n, offs, seed=3)
    if kind == "empty":
        rows = np.zeros(0, np.int64)
    elif kind == "random":
        rows = np.sort(rng.integers(0, n, 2000))
    elif kind == "heavy_tile":
        rows = np.sort(np.concatenate([rng.integers(4096, 6144, 3000), rng.integers(0, n, 100)]))
    elif kind == "heavy_row":
        rows = np.sort(np.concatenate([np.full(600, 5000), rng.integers(0, n, 100)]))
    else:
        rows = np.sort(np.concatenate([rng.integers(0, n, 500), rng.integers(9000, n, 300)]))
    cols = rng.integers(0, n, len(rows))
    H = lt.sparse.convert.hyb_from_parts(D.to(dtype=torch.float32), rows, cols,
                                         0.1 * rng.standard_normal(len(rows)), (n, n))
    return H.to(device=cuda, dtype=torch.bfloat16)


@pytest.mark.parametrize("pin", RING_PINS, ids=lambda p: "plan" if p is None else f"T{p[0]}S{p[1]}")
@pytest.mark.parametrize("kind", ["empty", "random", "heavy_tile", "heavy_row", "partial_tile"])
def test_ring_k3_equals_rowwise_bitwise(cuda, kind, pin):
    from lssp_tpu_torch.ops.dia_spmv import ROWWISE
    H = _ring_hyb(kind, cuda)
    n = H.shape[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.rand(n, generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    z = (torch.rand(n, generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, z)):
        plan = _ring_plan(H.shape, H.dia.offsets, zz is not None, pin, rem=True)
        before = hyb_spmv.by_route.get("ring", 0)
        y = hyb_spmv(H, x, alpha, beta, zz, plan=plan)
        ref = hyb_spmv(H, x, alpha, beta, zz, plan=ROWWISE)
        torch.cuda.synchronize()
        assert hyb_spmv.by_route["ring"] == before + 1
        assert _bits_equal(y, ref), (y.float() - ref.float()).abs().max().item()
        assert _one_ulp(y, hyb_spmv_plain(H, x, alpha, beta, zz))


def test_ring_misaligned_takes_rowwise(cuda):
    """x one element into its buffer (2 bytes past 16-byte alignment), or n
    not a multiple of 8: the rowwise kernel, counted as such, the same y."""
    D = _ring_band(4096, 4096, (-64, -1, 0, 1, 64), seed=1).to(device=cuda)
    buf = torch.rand(4097, device=cuda).to(torch.bfloat16)
    x = buf[1:]
    dia_spmv.by_route.clear()
    y = dia_spmv(D, x)
    assert dia_spmv.by_route == {"rowwise": 1}
    y2 = dia_spmv(D, x.clone())
    assert dia_spmv.by_route == {"rowwise": 1, "ring": 1} and _bits_equal(y, y2)
    D7 = _ring_band(4095, 4095, (-64, -1, 0, 1, 64), seed=1).to(device=cuda)
    dia_spmv(D7, x[:4095].clone())
    assert dia_spmv.by_route["rowwise"] == 2


def test_bf16_solves_on_cuda_take_only_the_ring(cuda):
    """bf16 solve_ir cg + ILU(0) on 32³ (K1) and gmres(30) on a strayed
    32³ HYB (K3): every bf16 K1 / K3 launch takes the ring (the fp64 outer
    residuals take the rowwise fp64 kernels)."""
    bf = torch.bfloat16
    kw = dict(inner_dtype=bf, inner_rtol=3e-2, max_outer=60,
              options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, restart=30),
              pc_options=lt.PCOptions(ilu_sweeps=6))
    A = lt.sparse.laplacian_3d(32)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=cuda)
    dia_spmv.by_route.clear()
    dia_spmv.by_dtype.clear()
    x, info = lt.solve_ir(A, b, method="cg", pc="ilu0", **kw)
    assert info.converged and dia_spmv.by_dtype.get("bf16", 0) > 0
    assert dia_spmv.by_route.get("ring", 0) == dia_spmv.by_dtype["bf16"]
    L = lt.sparse.laplacian_3d(32).to_scipy()
    rng = np.random.default_rng(2)
    n = L.shape[0]
    E = sp.coo_matrix((0.01 * rng.standard_normal(300),
                       (rng.integers(0, n, 300), rng.integers(0, n, 300))), shape=L.shape)
    AH = lt.CSR.from_scipy((L + E).tocsr())
    hyb_spmv.by_route.clear()
    hyb_spmv.by_dtype.clear()
    x, info = lt.solve_ir(AH, b, method="gmres", pc="ilu0", **kw)
    assert info.converged and hyb_spmv.by_dtype.get("bf16", 0) > 0
    assert hyb_spmv.by_route.get("ring", 0) == hyb_spmv.by_dtype["bf16"]
