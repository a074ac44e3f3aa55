"""The frozen generators against a Kronecker assembly, the byte formulas
against hand counts, and the busy union and idle gaps on made-up
intervals."""
import types

import numpy as np
import pytest
import scipy.sparse as sp

from bench_port import generators, roofline, trace
from bench_port.record import Run


def lap1d(N, off=-1.0, diag=2.0):
    return sp.diags([np.full(N - 1, off), np.full(N, diag), np.full(N - 1, off)], [-1, 0, 1])


@pytest.mark.parametrize("N", [2, 3, 5])
def test_laplacian_3d_is_the_kronecker_sum(N):
    I, T = sp.identity(N), lap1d(N)
    ref = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I) + sp.kron(sp.kron(I, I), T))
    A = generators.laplacian_3d(N)
    assert A.shape == (N ** 3, N ** 3) and A.has_sorted_indices
    assert abs(A - ref).max() == 0
    assert A.nnz == 7 * N ** 3 - 6 * N ** 2


@pytest.mark.parametrize("N,eps", [(3, 0.01), (6, 0.5)])
def test_anisotropic_poisson_is_the_kronecker_sum(N, eps):
    I = sp.identity(N)
    ref = sp.kron(I, lap1d(N)) + eps * sp.kron(lap1d(N), I)
    A = generators.anisotropic_poisson_2d(N, eps)
    assert abs(A - ref).max() < 1e-15
    assert A.nnz == 5 * N * N - 4 * N


def test_build_reads_the_generator_arguments_from_the_configuration():
    A = generators.build({"generator": "anisotropic_poisson_2d", "N": 4, "epsilon": 0.25,
                          "rows": 16})
    assert abs(A - generators.anisotropic_poisson_2d(4, 0.25)).max() == 0


def test_structure():
    s = generators.structure(generators.laplacian_3d(4))
    assert s == {"n": 64, "nnz": 7 * 64 - 6 * 16, "nd": 7, "nd_lower": 3, "nd_upper": 3}


def test_byte_formulas_by_hand():
    n = 128 ** 3
    # K1 fp32 on the 7-point stencil: 7 bands, x in, y out
    assert roofline.k1_bytes(n, 7, 4) == 7 * n * 4 + n * 4 + n * 4
    assert roofline.k1_bytes(n, 7, 8) == 2 * roofline.k1_bytes(n, 7, 4)
    # K1k: the bands once, 8 columns in and 8 out
    assert roofline.k1k_bytes(n, 7, 8, 4) == 7 * n * 4 + 16 * n * 4
    # K2: 3 bands of L, 3 of U, the inverse diagonal, r in, z out
    assert roofline.k2_bytes(n, 3, 3, 4) == (3 + 3 + 1) * n * 4 + 2 * n * 4
    assert roofline.k2k_bytes(n, 3, 3, 8, 4) == 7 * n * 4 + 16 * n * 4
    assert roofline.k2_bytes(n, 3, 3, 4) == 75497472     # PERF.md: 75 MB an apply


def test_share():
    peak = 1e12
    launches = [(4, 2e-6), (4, 2e-6)]                    # 1 MB each at 1 TB/s: 1 us each
    assert roofline.share(launches, lambda s: 1e6, peak) == pytest.approx(50.0)
    assert roofline.share([], lambda s: 1e6, peak) is None
    assert roofline.share(launches, lambda s: 1e6, None) is None
    assert roofline.share([(None, 1e-6)], lambda s: 1e6, peak) is None


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (8, 9)]
    assert trace.union_seconds(spans) == 5
    assert trace.idle_gaps(spans, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert trace.union_seconds([]) == 0
    assert trace.idle_gaps([], 0, 1) == [(0, 1)]


def test_kernel_names():
    full = "void (anonymous namespace)::dia_spmv_kernel<float>(float const*, int const*, int)"
    assert trace.short_name(full) == "dia_spmv_kernel"
    assert trace.first_template_arg(full) == "float"
    k2 = "void (anonymous namespace)::neumann_wavefront_kernel<double, 8>(Apply<double>)"
    assert trace.short_name(k2) == "neumann_wavefront_kernel"
    assert trace.first_template_arg(k2) == "double"
    assert trace.first_template_arg("Memcpy DtoH (Device -> Pageable)") is None
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def fake_event(name, a, b, cuda, annotation=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                                 is_user_annotation=annotation)


def test_reduce_events_and_the_kernel_share():
    ev = [fake_event("aten::item", 0, 40, False),
          fake_event("void (anonymous namespace)::dia_spmv_kernel<float>(float const*)", 10, 20,
                     True),
          fake_event("void (anonymous namespace)::dia_spmv_kernel<double>(double const*)", 30,
                     35, True),
          fake_event("cudaStreamSynchronize", 50, 90, False),
          fake_event("void foo<float>(float)", 95, 100, True),
          fake_event("nccl:all_gather", 95, 100, True, annotation=True)]
    p = trace.reduce_events(ev, wall_s=100e-6)
    assert p.busy_s == pytest.approx(20e-6)
    assert p.launches() == 3
    # the gap 35-95 goes whole to the op running at its middle
    assert p.gaps_by_host_op == pytest.approx({"aten::item": 20e-6,
                                               "cudaStreamSynchronize": 60e-6})
    assert p.kernel_launches("dia_spmv_kernel") == [(4, pytest.approx(10e-6)),
                                                    (8, pytest.approx(5e-6))]
    b = p.breakdown()
    assert b["device_ops"][0] == ["dia_spmv_kernel", pytest.approx(15e-6)]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(60e-6)]
    run = Run(cell="c", config={}, traffic={"k": 1}, latencies=[1.0], nits=[np.array([3])],
              window_s=1.0, setup_s=1.0, profiles=[p], profiled=[0],
              matrix={"n": 1000, "nd": 3, "nd_lower": 1, "nd_upper": 1},
              card="NVIDIA H100 80GB HBM3")
    least = (roofline.k1_bytes(1000, 3, 4) + roofline.k1_bytes(1000, 3, 8)) / 3.35e12
    got = roofline.kernel_share(run, "dia_spmv_kernel",
                                lambda m, k, s: roofline.k1_bytes(m["n"], m["nd"], s))
    assert got == pytest.approx(100 * least / 15e-6)
