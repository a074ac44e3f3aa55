#!/usr/bin/env python3
"""Drive the lssp_tpu_torch solve path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the final result line):

1. stack: the card's name and power limit, torch.version.cuda, nvcc, and
   the seconds it took to build the CUDA kernels from this checkout;
2. K1 (DIA SpMV) against its plain PyTorch version on the card;
3. K2 (Neumann ILU apply) against its plain PyTorch version;
4. the main path at the acceptance size: solve_ir, CG + ILU(0), on the
   3-D Poisson 64³, with every kernel launch counter reset just before;
5. the same solve on 128³;
6. the reference example (GMRES(60) + ILU(1), 2-D Laplacian N=100) through
   the Solver lifecycle in fp64.

Kernel times are given twice: ``ms`` is device time per call, from CUDA
events around the replay of a CUDA graph that holds back-to-back calls, so
the Python wrapper's checks and ctypes call are not in it; ``host_ms`` is
the time per call of the same calls issued from Python, which at the main
path's shapes is bound by that host cost.

The line before the last is a JSON object with one entry per kernel, at
the shape the main path gives it; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, samples=25, inner=10, warmup=5):
    """Median milliseconds per call over ``samples`` CUDA-event windows of
    ``inner`` back-to-back calls each, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls=20, samples=15):
    """Median device milliseconds per call: ``calls`` calls captured into one
    CUDA graph (after a warm-up on a side stream), the graph replayed
    ``samples`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    del graph
    torch.cuda.synchronize()
    return times[len(times) // 2]


def timings(kernel, plain, inner=10, calls=20):
    """Device and host-issued milliseconds per call of a kernel's wrapper and
    its plain version."""
    return dict(ms=graph_ms(kernel, calls), plain_ms=graph_ms(plain, calls),
                host_ms=cuda_ms(kernel, inner=inner),
                plain_host_ms=cuda_ms(plain, inner=inner))


def stack(kernels):
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    kernels.load()
    load_s = time.perf_counter() - t0
    print(card)
    print(f"stack: torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"{nvcc}, kernel build {kernels.build_seconds} s (load {load_s:.3f} s)")
    return card


def rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def phase_k1(lt, np, torch, dev):
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(0)
    cases = [("laplacian_2d(2048)", lt.sparse.laplacian_2d(2048), (1.0, 0.25)),
             ("laplacian_3d(64)", lt.sparse.laplacian_3d(64), (1.0, 0.25)),
             ("laplacian_2d(1021)", lt.sparse.laplacian_2d(1021), (1.0,))]
    main = None
    for name, A, scales in cases:
        D64 = lt.sparse.csr_to_dia(A, device=dev)
        x64 = torch.from_numpy(rng.uniform(-1, 1, A.shape[0])).to(dev)
        for dtype in (torch.float32, torch.float64):
            D = D64.to(dtype=dtype)
            x = x64.to(dtype)
            for scale in scales:
                y = dia_spmv(D, x, alpha=scale)
                ref = dia_spmv_plain(D.data, D.offsets, x, alpha=scale)
                torch.cuda.synchronize()
                err = rel_err(y, ref)
                abs_err = (y - ref).abs().max().item()
                check(bool(torch.isfinite(y).all()), f"K1 {name}: non-finite output")
                check(err <= tol[dtype], f"K1 {name} {dtype} scale {scale}: "
                      f"max rel err {err:.3e} > {tol[dtype]:.0e}")
                t = timings(lambda: dia_spmv(D, x, alpha=scale),
                            lambda: dia_spmv_plain(D.data, D.offsets, x, alpha=scale))
                n, nd = A.shape[0], len(D.offsets)
                gbps = (nd * n + 2 * n) * x.element_size() / (t["ms"] * 1e-3) / 1e9
                print(f"K1 {name} n={n} ndiag={nd} {str(dtype)[6:]} scale={scale}: "
                      f"max_rel_err {err:.3e} max_abs_err {abs_err:.3e}; device: K1 "
                      f"{t['ms'] * 1e3:.2f} us ({gbps:.1f} GB/s), plain "
                      f"{t['plain_ms'] * 1e3:.2f} us; issued from Python: K1 "
                      f"{t['host_ms'] * 1e3:.2f} us, plain {t['plain_host_ms'] * 1e3:.2f} us")
                if name == "laplacian_3d(64)" and dtype == torch.float32 and scale == 1.0:
                    main = dict(max_abs_err=abs_err, **t)
    return main


def strayed_laplacian(lt, np, n1d, frac, seed=0):
    """2-D Laplacian plus random long-range couplings (a dominant band with
    a scattered remainder)."""
    import scipy.sparse as sp
    A = lt.sparse.laplacian_2d(n1d)
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    k = int(frac * n)
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    keep = r != c
    E = sp.coo_matrix((0.1 * rng.standard_normal(keep.sum()), (r[keep], c[keep])),
                      shape=A.shape)
    M = (A.to_scipy() + E.tocsr()).tocsr()
    M.sort_indices()
    return lt.sparse.CSR.from_scipy(M)


def phase_k2(lt, np, torch, dev):
    from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                            plan_fused_neumann)
    from lssp_tpu_torch.pc.ilu_host import iluk_factor
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(1)
    cases = [("ilu0 laplacian_3d(64)", lt.sparse.laplacian_3d(64), 0),
             ("iluk(1) laplacian_2d(256)+0.5% strays",
              strayed_laplacian(lt, np, 256, 0.005), 1)]
    main = None
    for name, A, level in cases:
        L, U = iluk_factor(A, level=level)
        r64 = torch.from_numpy(rng.standard_normal(A.shape[0])).to(dev)
        for dtype in (torch.float32, torch.float64):
            plan = plan_fused_neumann(L, U, 6, dtype=dtype, device=dev)
            if level:
                check(plan.L.stray_ptr is not None or plan.U.stray_ptr is not None,
                      f"K2 {name}: the plan has no strays")
            r = r64.to(dtype)
            z = fused_neumann_apply(plan, r)
            ref = neumann_apply_plain(plan, r)
            torch.cuda.synchronize()
            err = rel_err(z, ref)
            abs_err = (z - ref).abs().max().item()
            check(bool(torch.isfinite(z).all()), f"K2 {name}: non-finite output")
            check(err <= tol[dtype], f"K2 {name} {dtype}: max rel err {err:.3e} > "
                  f"{tol[dtype]:.0e}")
            t = timings(lambda: fused_neumann_apply(plan, r),
                        lambda: neumann_apply_plain(plan, r), inner=3, calls=10)
            print(f"K2 {name} n={A.shape[0]} sweeps=6 {str(dtype)[6:]}: max_rel_err "
                  f"{err:.3e} max_abs_err {abs_err:.3e}; device: K2 {t['ms'] * 1e3:.1f} "
                  f"us/apply, plain {t['plain_ms'] * 1e3:.1f} us/apply; issued from "
                  f"Python: K2 {t['host_ms'] * 1e3:.1f} us/apply, plain "
                  f"{t['plain_host_ms'] * 1e3:.1f} us/apply")
            if level == 0 and dtype == torch.float32:
                main = dict(max_abs_err=abs_err, **t)
    return main


def true_relres(A, x, np):
    b = np.ones(A.shape[0])
    return float(np.linalg.norm(b - A.to_scipy() @ x.cpu().numpy()) / np.linalg.norm(b))


def ir_solve(lt, torch, dev, A):
    """CG + ILU(0) through solve_ir: setup, then two solves (cold, warm)."""
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    lt.prepare_ir(A, method="cg", pc="ilu0", device=dev)
    setup_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.solve_ir(A, b, method="cg", pc="ilu0", options=opts)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return x, info, setup_s, runs


def phase_main(lt, np, torch, dev, counters):
    A = lt.sparse.laplacian_3d(64)
    for fn in counters:
        fn.launches = 0
    x, info, setup_s, runs = ir_solve(lt, torch, dev, A)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    print(f"main 64^3 solve_ir cg+ilu0: inner its {info.nits}, true relres {rr:.3e}, "
          f"setup {setup_s:.3f} s, solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s, "
          f"launches {launches}")
    check(rr <= 1e-8, f"64^3: true relres {rr:.3e} > 1e-8")
    check(info.nits <= 114, f"64^3: {info.nits} inner iterations > 114")
    for name, count in launches.items():
        check(count > 0, f"64^3: kernel {name} was never launched on the main path")
    return launches


def phase_128(lt, np, torch, dev):
    A = lt.sparse.laplacian_3d(128)
    x, info, setup_s, runs = ir_solve(lt, torch, dev, A)
    rr = true_relres(A, x, np)
    print(f"main 128^3 solve_ir cg+ilu0: inner its {info.nits}, true relres {rr:.3e}, "
          f"setup {setup_s:.3f} s, solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s")
    check(rr <= 1e-8, f"128^3: true relres {rr:.3e} > 1e-8")


def phase_exam(lt, np, torch, dev):
    A = lt.sparse.laplacian_2d(100)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    s = lt.Solver("gmres", "iluk", pc_options=lt.PCOptions(ilu_sweeps=0), device=dev)
    s.set_restart(60).set_maxit(3000)
    t0 = time.perf_counter()
    s.assemble(A, b)
    x = s.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ver = float(np.linalg.norm(np.ones(A.shape[0]) - A.to_scipy() @ x.cpu().numpy()))
    print(f"exam gmres(60)+iluk N=100 fp64: nits {s.nits}, residual {s.residual:.8e}, "
          f"verification {ver:.8e}, {secs:.3f} s")
    check(abs(s.nits - 49) <= 1, f"exam: {s.nits} iterations, expected 49 +- 1")
    check(ver <= 2 * 8.18e-6, f"exam: verification residual {ver:.3e} > {2 * 8.18e-6:.3e}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import numpy as np
    import lssp_tpu_torch as lt
    from lssp_tpu_torch import _kernels
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply
    check(os.path.dirname(os.path.abspath(lt.__file__)) == os.path.join(HERE, "lssp_tpu_torch"),
          f"lssp_tpu_torch was imported from {lt.__file__}, not from this checkout")
    dev = torch.device("cuda:0")
    stack(_kernels)
    k1 = phase_k1(lt, np, torch, dev)
    k2 = phase_k2(lt, np, torch, dev)
    launches = phase_main(lt, np, torch, dev, (dia_spmv, fused_neumann_apply))
    phase_128(lt, np, torch, dev)
    phase_exam(lt, np, torch, dev)
    kernels = [
        dict(name="dia_spmv", route="cuda", source="lssp_tpu_torch/csrc/dia_spmv.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:91", launches=launches["dia_spmv"], **k1),
        dict(name="neumann_sweep", route="cuda", source="lssp_tpu_torch/csrc/neumann.cu",
             replaces="lssp_tpu/ops/pallas_neumann.py:196",
             launches=launches["fused_neumann_apply"], **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
