#!/usr/bin/env python3
"""Drive the lssp_tpu_torch solve path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the script exits
non-zero without the final result line):

1. stack: the card's name and power limit, torch.version.cuda, nvcc, and
   the seconds it took to build the CUDA kernels from this checkout;
2. K1 (DIA SpMV) against its plain PyTorch version on the card;
3. K2 (the Neumann ILU apply, one wavefront launch an apply) against its
   plain PyTorch version (ILU(0) 64³ and 128³, ILU(1) with strays, and an
   adversarial plan: ILU(0)'s 128³ pattern with random values of order 1),
   fp32 and fp64, repeated applies bitwise equal, with device µs, GB/s
   and share of the bound;
4. the main path at the acceptance size: solve_ir, CG + ILU(0), on the
   3-D Poisson 64³, with every kernel launch counter reset just before;
5. the same solve on 128³, and one more warm solve under torch.profiler:
   launches per inner iteration, device busy, K2's share of device time;
6. the reference example (GMRES(60) + ILU(1), 2-D Laplacian N=100) through
   the Solver lifecycle in fp64 (``lssp_tpu_torch.examples.exam``);
7. K3 (HYB SpMV) against its plain PyTorch version: the HYB matrix of
   ``bench.py`` (2-D Laplacian 2048² plus n//200 strays of 0.01), the
   vendored coupled3d_25, and a 1021² case whose n is not a multiple of
   the block, in fp32 and fp64, for (alpha, beta) = (1, 0), (0.25, 0) and
   (1, 1) with z;
8. the HYB path: solve_ir, BiCGSTAB + ILU(0), on the 3-D Laplacian 128³
   with the same stray recipe, every kernel launch counter reset just
   before; then K3 and K2 checked against their plain versions on that
   solve's own fp32 matrix and preconditioner plan, and K3 timed there;
9. the acceptance config bicgstab_iluk_coupled3d_mtx (read from
   benchmarks/matrices, HYB), K3 and K2 checked likewise after it;
10. the acceptance config gmres30_ilut_convdiff_mtx (DIA), K1 and K2
   checked likewise after it;
11. K4 (the per-shard DIA SpMV of the distributed solve) alone: the 3-D
   Laplacian 128³ and the 2-D Laplacian 1000² over 8 shards, fp32 and
   fp64, against its plain version for the product and the sweep epilogue
   (−1, 1, z), and the distributed product (halo exchange, then K4)
   against K1 on the same matrix unpartitioned;
12. the distributed path: dist_solve_ir, CG + ILU(0) (block-Jacobi, 6
   Neumann sweeps), on 128³ over 8 shards of this card, every kernel
   launch counter reset just before; only K4 may launch; then K4 checked
   against its plain version on that solve's own fp32 partition and
   per-shard Neumann factors, and timed there;
13. the DistHYB path: dist_solve_ir, BiCGSTAB + Jacobi, on 128³ + 10,485
   strays over 8 shards; K4 checked on that solve's band;
14. the k-rhs kernels alone, each against its plain version and against k
   launches of its single-rhs kernel on the same columns: K1k on 128³ at
   k = 1, 4, 8 in fp32 and fp64; K3k on phase 8's strayed 128³ HYB, K2k on
   the 128³ ILU(0) plan and K4k on phase 11's 128³ P = 8 partition, all at
   k = 8 in fp32 (K2k also in fp64, at k = 3 and on the adversarial plan,
   repeats bitwise equal); device times of the form, its plain version and
   the k single launches, with GB/s (K2k's share of its bound);
15. serving, the multi-rhs main path: solve_ir_multi, block CG + ILU(0),
   on 128³ with B = 8 columns of default_rng(0).standard_normal, every
   kernel launch counter reset just before; only the k-rhs forms may
   launch; the first and warm walls against 8 sequential solve_ir (cg +
   ILU(0)) on the same columns (bench.py's serving8 protocol), and a
   profiled warm solve (launches per inner iteration, busy, K2k's share);
16. the per-column path: solve_multi, CG + ILU(0), fp64, 64³, k = 4, each
   column's count against its own single solve;
17. HYB multi: solve_ir_multi, block GMRES + ILU(1), k = 4, on the vendored
   coupled3d_25; K3k and K2k must launch and nothing else;
18. distributed multi: dist_solve_ir_multi, block CG + ILU(0), on 128³ over
   8 shards of this card, k = 8; only K4k may launch.
After each of phases 15-18 its k-rhs kernels (K1k or K3k and K2k; K4k for
18, on the partition and the per-shard Neumann factors) are checked on
that solve's own matrix and plan with its own block, in its own dtype,
against their plain versions and against k single-rhs launches.
The AMG phases (every kernel launch counter reset just before each solve):
19. the slice's main path, ``bench.py``'s tts1e8_gmres_saamg: solve_ir,
   GMRES(30) + saamg, on the anisotropic Poisson 1024² (epsilon 0.01,
   1,048,576 rows), b = 1: ≤ 24 inner iterations (the TPU's 21 + 15 %),
   true relres ≤ 1e-8, only K1 among the kernels; the setup split, the
   hierarchy, launches per inner iteration and the device-busy share of a
   profiled warm solve; then K1 against its plain version on every DIA
   level's A, B and C, in fp32 and fp64;
20. the classical ``amg`` route, acceptance's gmres_amg_aniso as it runs
   off the TPU (the Solver, fp64, GMRES(30)) on the anisotropic Poisson
   512² (epsilon 1e-3): ≤ the JAX CPU count + 15 %; each level's format;
   K1 (and K3 on a HYB level) checked on the levels;
21. ``rsamg``: solve_ir, CG + rsamg, on the 3-D Laplacian 64³;
22. the block path: solve_ir_multi, block GMRES + saamg, on the
   anisotropic Poisson 512² (epsilon 0.01) with 8 columns: only K1k (and
   K1) may launch; K1k checked on the levels against its plain version and
   8 single launches.
The JAX CPU counts of phases 20-22 come from
``scripts/jax_amg_reference.py``.
The general Krylov methods (every kernel launch counter reset just
before each solve, each phase's time printed):
23. solve_ir + ILU(0) (K2, 6 sweeps), rtol 1e-8, on the 3-D Laplacian 128³
   for each of cgs, cr, crs, bicrstab, bicgsafe, bicrsafe, gpbicg, gpbicr,
   qmrcgstab, tfqmr, orthomin, bicgstabl, idrs, lgmres, rlgmres, minres
   and fgmres: inner its (≤ the JAX CPU count + 15 %; 1.5 times for the
   cells whose count moves with rounding alone, ``ROUNDING_SENSITIVE``),
   outer rounds, the warm wall, K1 and K2 launches an inner iteration, the
   true relres (≤ 1e-8); only K1 and K2 may launch; then K1 and K2 against
   their plain versions on the phase's own fp32 matrix and plan, and a
   profiled first refinement round of the three slowest methods;
24. the same on the convection-diffusion 1024² (beta 20, unsymmetric,
   1,048,576 rows), minres left out (it needs a symmetric A); a method
   whose JAX run stalls is held to the same stall, bicrstab excepted;
25. solve_multi + ILU(0), fp64, 48³ (64³ took phases 23-25 past 90 s),
   k = 4, for each method: every column's count its own single solve's
   ±1, only K1k and K2k launch for the block; then K1k and K2k on the
   solve's own fp64 matrix and plan.
The JAX CPU counts of phases 23-24 come from
``scripts/jax_krylov_reference.py``.
Block matrices and the distributed AMG (every kernel launch counter reset
just before each solve, each phase's time printed):
26. solve_ir, BiCGSTAB(l) + biluk (2×2 blocks, 6 Neumann sweeps over BDIA
   factors), on the elasticity 512² as a BSR (524,288 rows): the prepared
   format is scalar DIA, only K1 launches, inner its ≤ the JAX CPU count +
   15 %, true relres ≤ 1e-8; the host setup split (BSR → CSR, CSR → DIA,
   block factorization, BDIA packing) apart from the warm solve; K1 on the
   phase's own matrix; then the acceptance config
   bicgstabl_biluk_elasticity (its TPU route, solve_ir with 6 sweeps,
   recorded at 111: ≤ JAX's CPU count under fp32-ulp changes of b + 15 %,
   as that count moves with rounding; its CPU route, the fp64 Solver with
   the exact block schedules, JAX's count ±1), and
   solve_ir_multi block CG + biluk, k = 4, on the 512² BSR: only K1k;
27. the distributed AMG on 8 shards of the card: dist_solve_ir GMRES(30) +
   saamg on phase 19's anisotropic 1024² (≤ JAX's CPU count + 15 %, within 3
   of phase 19's count), CG + rsamg on 64³ (≤ JAX's distributed CPU count +
   15 %), dist_solve GMRES(30) + amg fp64 on the anisotropic 512², and
   dist_solve_ir_multi block CG + saamg 512², k = 8: the saamg and rsamg
   cells launch only K4 (K4k), and K4 is checked on every DistDIA level.
The JAX CPU counts of phases 26-27 come from
``scripts/jax_amg_reference.py``.
The transpose path and the relaxation, polynomial and Schwarz PCs (every
kernel launch counter reset just before each solve, each phase's time
printed):
28. solve_ir + ILU(0) (6 sweeps: K2 forward, K2 on the transposed plan for
   M⁻ᵀ), rtol 1e-8, on the 3-D Laplacian 128³ for bicg, qmr, cgnr and lsqr,
   and bicg and qmr on the convection-diffusion 1024²: inner its ≤ the JAX
   CPU count + 15 %, true relres ≤ 1e-8, K1, K2 and transposed-K2
   launches an inner iteration, only K1 and K2 launch; K2 and K2k against
   their plain versions on the phase's own transposed fp32 plan and on an
   fp64 one, that plan's plain apply against ``neumann_ilu_apply_t``; a
   profiled first refinement round of bicg and cgnr; the tall lsqr
   (``solve``, fp64, no PC) on [L; 0.1·I], L = ``laplacian_2d(1024)``
   (2,097,152 × 1,048,576, HYB on K3), b = A·1: ≤ JAX's count through ELL
   + 15 %, ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ ≤ 1e-6, K3 against scipy and its plain
   version on the phase's own matrix; per-column solve_multi fp64 48³,
   k = 4, for the four methods (each column its single solve ± 1, only K1k
   and K2k, K2k also on the transposed plan); dist_solve_ir bicg + bjilu
   and qmr + jacobi on 128³ over 8 shards (only K4);
29. solve_ir on 128³ with cg + ssor, poly, chebyshev; gmres(30) + sor
   (ω 1.3), gs, ras, schwarz, bjacobi (512 blocks, overlap 8); bicg + ssor
   (the transposed relaxation plan on K2) and qmr + poly (``spmv_t`` in
   its transpose): ≤ JAX's CPU count + 15 %, true relres ≤ 1e-8, only K1
   and K2, each PC's host setup apart from the warm solve; K2 on the ssor,
   sor and ras plans and K1 on poly's matrix against their plain versions.
The JAX CPU counts of phases 28-29 come from
``scripts/jax_krylov_reference.py 28 28cd 28tall 28dist 29`` (cgnr and
lsqr with the port's inner cap, the ssor / sor / gs factors in the
matrix's dtype; both are JAX defects the port does not copy, ROADMAP C).
The direct solvers, ilutp, arms and the communication-avoiding methods
(every kernel launch counter reset just before each solve, each phase's
time printed):
30. solve(method="direct") (pc="lu": AMD, the multifrontal LU on the host,
   exact level-scheduled sweeps on the card) on the 2-D Laplacian 512²,
   coupled3d_25 and convdiff_rot_128: nits 1, true relres ≤ 1e-9, x
   against scipy's spsolve (≤ 1e-8 on the Laplacian), the factorization
   split, the factor's nnz, the schedules' levels and slots, one apply's
   time and device launches, only K1 / K3 (the residual products);
   Solver(method="direct") on 512²: one numeric factorization for 3
   right-hand sides and a k = 8 solve_multi whose columns equal their
   single solves to 1e-12; solve_ir(method="direct"), the fp32 LU inner,
   relres ≤ 1e-8; solve_lsq, qr (host Givens QR, run last) and normal
   (the LU of AᵀA swept on the card), on [L; 0.1·I], L =
   laplacian_2d(128) (32,768 × 16,384): ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ ≤ 1e-10
   and x within 1e-8 of spsolve(AᵀA, Aᵀb), x on the card;
   K1 / K3 on the residuals' matrices at the path's dtypes;
31. solve_ir gmres(30) + ilutp (6 sweeps) on coupled3d_25 and the
   convection-diffusion 256², the columns the pivoting moved, K2 on the
   permuted fp32 and fp64 plans and, through bicg + ilutp, on the
   transposed plan; the tiny-diagonal pivot system at n = 128 through
   solve gmres fp64, 6 sweeps (≤ JAX + 15 %) and exact (≤ 5), the
   pivoting engaged; solve_ir gmres(30) + arms on the convection-diffusion
   and the anisotropic (ε 0.01) 256², with the levels, the coarse n and
   its schedule, the setup and one apply's time; solve_ir + ILU(0) on
   128³ with cg, pipecg, gmres(30) and cagmres(30), pipecg's count minus
   cg's;
   dist_solve_ir pipecg + bjilu on 128³ over 8 shards: only K4, one
   reduction over the shards an inner iteration (counted), K4 on its
   partition; per column, solve_multi fp64 48³, k = 4, pipecg and cagmres.
The bf16 inner precision, utils/ and the examples (every kernel launch
counter, and its count by dtype, reset just before each solve):
32. the bf16 forms of K1, K3, K4, K1k, K3k and K4k alone, at phase 2 / 7 /
   11 / 14's shapes, each within one bf16 ulp (7.9e-3 relative, over the
   entries with |y| ≥ 1e-3·max|y|) of its plain version, with device µs,
   GB/s and share of the bound (K3's indices at 4 bytes: nnz_rem·10 +
   ptr·4) and the bf16 ``torch.sparse_csr_tensor`` product's time where
   torch takes it; K1 and K3 run on the band ring (``csrc/band_ring.cuh``),
   held bitwise to the rowwise kernel there and on the 128³ band and
   strayed HYB, timed in turns with it (rowwise, ring, ring, rowwise), and
   over every tile and stage count T × S that fits; every bf16 K1 / K3
   launch of the solve cells below must take the ring; then solve_ir cg +
   ILU(0), bf16 inner, inner_rtol 3e-2, max_outer 60, 6 sweeps: 64³ ≤
   JAX's CPU count + 15 % (``JAX_CPU_BF16``), 128³
   beside the fp32 solve's count and warm wall, only K1 in bf16 and K2 on
   its fp32 plan; GMRES(30) + ILU(0) on phase 8's strayed 128³ (K3 in
   bf16), and BiCGSTAB + ILU(0) there reported, not held (JAX's own bf16
   BiCGSTAB diverges on that recipe at 64³, ``JAX_CPU_BF16_HYB``);
   dist_solve_ir cg + bjilu over 8 shards of 128³ (only K4, in
   bf16); per-column solve_ir_multi cg (K1k) and gmres(30) on a strayed
   64³ (K3k) and dist_solve_ir_multi cg + bjilu (K4k), k = 4; every held cell
   true relres ≤ 1e-8, each kernel checked on its solve's own bf16 matrix;
33. utils/: checkpointed_solve cg + ILU(0) 128³ fp64 every 50, interrupted
   after 2 rounds and resumed, x bitwise equal to an uninterrupted run's;
   a checkpoint of x and the PC (MB, save and load seconds), the restored
   PC applying bitwise; set_log's tee; the profile ledger of the run;
   device_memory_mb; the fingerprint's ms on the 128³ CSR (crc32 beside
   adler32); nan_guard raising on a solve and on a kernel;
34. ``python -m lssp_tpu_torch.examples.tour`` and ``.distributed`` at full
   size, each section within 2 of JAX's CPU count (``JAX_CPU_TOUR``, from
   ``scripts/jax_krylov_reference.py tour``, the ILU PCs at the card's 6
   sweeps), the fp32 / bf16 inner sections held to their residual.
35. the communicator: ``multihost.initialize(device="cuda")`` over a
   ``file://`` rendezvous of its own (an NCCL group of one rank) and
   ``global_mesh(slots=8)``; on it, each beside the group-less mesh of 8
   slots, timed in turns (first call, then warm calls), with the
   collectives a call (``dist_ops.collectives``): dist_solve_ir CG + ILU(0)
   on 128³ (x bitwise the group-less x, the same inner count in [194, 262],
   true relres ≤ 1e-8, only K4, K4 on the solve's partition and factors,
   a profiled warm solve through the group), dist_solve_ir_multi block CG + ILU(0)
   on 64³, k = 8 (the block solver's ``reduce=``: X within 1e-12 relative
   of the group-less X, the same counts, only K4k), and dist_solve_ir
   BiCGSTAB + Jacobi on the strayed 64³ as a DistHYB (the remainder's
   all-gather: x bitwise, the same count).  A world size above 1 needs
   more cards than one; the CPU tests hold W = 2 and 4 gloo ranks.
36. the distributed AMG through the group: a new NCCL group of one rank and
   ``global_mesh(slots=8)``, each cell beside the group-less 8-slot mesh in
   turns (first call, then a warm call each way), with the launches and
   ``dist_ops.collectives`` of the group call, a call and an inner
   iteration: (a) dist_solve_ir GMRES(30) + saamg on the anisotropic 1024²
   (ε 0.01, phase 27's cell), (b) the same at 256² with the line smoother
   (the Spike interface all-gather), (c) dist_solve_ir CG + rsamg on 64³,
   (d) dist_solve GMRES(30) + classical amg fp64 on the anisotropic 512²
   (ε 1e-3; every level product all-gathers its vector): x bitwise the
   group-less x, the same count, true relres ≤ 1e-8; (e)
   dist_solve_ir_multi block CG + saamg 512², k = 8: X within 1e-12
   relative, the same counts; (a), (c) and (e) launch only K4 (K4k), K4
   checked on level 0 of each of their hierarchies.
Phase 6 runs ``lssp_tpu_torch.examples.exam``'s ``main``.  ``python3
chip_smoke.py --only 32,33,34`` runs phases 32-34 alone, ``--only 35``
phase 35, ``--only 36`` phase 36.
JAX cannot run phase 30's direct cells (its padded level schedules would
need 1e9-1e12 slots; ROADMAP C property 14): they are held to scipy, and
``scripts/jax_krylov_reference.py 30`` gives JAX's host factors'
statistics there; phase 31's counts (``JAX_CPU_DIRECT``) come from
``scripts/jax_krylov_reference.py 31``.
``python3 chip_smoke.py --only 28,29`` runs those two phases alone (a
development run: no kernel line, no result line), as ``--only 30,31``
does phases 30-31.  Then one step that no solve path uses
times, for each kernel of the JSON line at its shape there, the one
PyTorch call that computes the same function (a ``torch.sparse_csr_tensor``
product through cuSPARSE; 12 ``torch.addmm`` for a Neumann apply) as
``library_ms``, and computes ``bound_ms``: the larger of the bytes each
input read once and each output written once over 3.35 TB/s and the
floating-point operations over 67 TFLOP/s (fp32) or 34 TFLOP/s (fp64).

Kernel times are given twice: ``ms`` is device time per call, from CUDA
events around the replay of a CUDA graph that holds back-to-back calls, so
the Python wrapper's checks and ctypes call are not in it; ``host_ms`` is
the time per call of the same calls issued from Python, which at the main
path's shapes is bound by that host cost.

The line before the last is a JSON object with one entry per kernel: its
launches on its path (K1 and K2 from phase 4, K3 from phase 8, K4 from
phase 12, K1k and K2k from phase 15, K3k from phase 17, K4k from phase
18; the bf16 forms, ``*_bf16``, from phase 32's path cells, timed at
phase 32's shapes) and its times, library time and bound at one shape
whose inputs do
not fit the 50 MB L2, so that back-to-back calls read HBM as the bound
assumes (K1 on the 2-D Laplacian 2048² from phase 2, K2 on ILU(0) 128³
from phase 3, K3 from phase 8, K4 from phase 12, the k-rhs forms from
phase 14 at 128³, k = 8); the last line is ``{"ok": true, "device":
{...}}``.
"""
import dataclasses
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
    # the band ring's kernels (K1 / K3 in bf16): registers, shared memory, spills
    lines = [l for l in kernels.ptxas_lines("band_ring")
             if "Compiling entry" in l or "Used" in l or "spill" in l]
    for line in lines:
        print(f"ptxas -v {line}")
    if not lines:
        print("ptxas -v: the kernel library was built by an earlier process; no report")
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
                # the JSON line's shape: 4.2M rows, 117 MB, out of the 50 MB L2
                if name == "laplacian_2d(2048)" and dtype == torch.float32 and scale == 1.0:
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


def adversarial_factors(lt, np, A, seed=0):
    """ILU(0) factors of A's pattern with random values of order 1 (U's
    diagonal of magnitude 1-2), so that the Neumann levels differ by O(1)
    and a value read from the wrong level or ring slot shows."""
    import dataclasses
    from lssp_tpu_torch.pc.ilu_host import iluk_factor
    L, U = iluk_factor(A, level=0)
    rng = np.random.default_rng(seed)
    ud = rng.uniform(-1, 1, U.data.shape)
    diag = U.indices == np.repeat(np.arange(U.shape[0]), np.diff(U.indptr))
    ud[diag] = np.sign(ud[diag]) + ud[diag]
    return (dataclasses.replace(L, data=rng.uniform(-1, 1, L.data.shape)),
            dataclasses.replace(U, data=ud))


def neumann_bytes(plan, k, itemsize):
    """The bound's bytes of one apply: both factors (band, strays and their
    index) and 1/diag read once, r read once, the output written once."""
    n, nbytes = plan.n, 0
    for F in (plan.L, plan.U):
        nbytes += len(F.offsets) * n * itemsize
        if F.stray_ptr is not None:
            nbytes += F.stray_cols.numel() * (itemsize + 4) + (n + 1) * 4
    return nbytes + (n + 2 * k * n) * itemsize


def neumann_flops(plan, k):
    """2 flops a stored factor entry a sweep and column, and the scaling."""
    nnz = sum(len(F.offsets) * plan.n + (0 if F.stray_cols is None else F.stray_cols.numel())
              for F in (plan.L, plan.U))
    return k * (2 * plan.sweeps * nnz + plan.n)


def repeat_equal(torch, fn, first, times):
    """``times`` more calls of ``fn``, each bitwise equal to ``first``."""
    for _ in range(times):
        if not torch.equal(fn(), first):
            return False
    return True


def phase_k2(lt, np, torch, dev):
    from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                            plan_fused_neumann)
    from lssp_tpu_torch.pc.ilu_host import iluk_factor
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(1)
    lap128 = lt.sparse.laplacian_3d(128)
    cases = [("ilu0 laplacian_3d(64)", lambda: iluk_factor(lt.sparse.laplacian_3d(64), level=0)),
             ("ilu0 laplacian_3d(128)", lambda: iluk_factor(lap128, level=0)),
             ("iluk(1) laplacian_2d(256)+0.5% strays",
              lambda: iluk_factor(strayed_laplacian(lt, np, 256, 0.005), level=1)),
             ("adversarial ilu0-pattern laplacian_3d(128), random O(1) values",
              lambda: adversarial_factors(lt, np, lap128))]
    main = None
    for name, factors in cases:
        L, U = factors()
        r64 = torch.from_numpy(rng.standard_normal(L.shape[0])).to(dev)
        for dtype in (torch.float32, torch.float64):
            plan = plan_fused_neumann(L, U, 6, dtype=dtype, device=dev)
            if "strays" in name:
                check(plan.L.stray_ptr is not None or plan.U.stray_ptr is not None,
                      f"K2 {name}: the plan has no strays")
            r = r64.to(dtype)
            z = fused_neumann_apply(plan, r)
            ref = neumann_apply_plain(plan, r)
            torch.cuda.synchronize()
            err = rel_err(z, ref)
            abs_err = (z - ref).abs().max().item()
            same = repeat_equal(torch, lambda: fused_neumann_apply(plan, r), z,
                                50 if "adversarial" in name else 5)
            check(bool(torch.isfinite(z).all()), f"K2 {name}: non-finite output")
            check(err <= tol[dtype], f"K2 {name} {dtype}: max rel err {err:.3e} > "
                  f"{tol[dtype]:.0e}")
            check(same, f"K2 {name} {dtype}: repeated applies differ")
            t = timings(lambda: fused_neumann_apply(plan, r),
                        lambda: neumann_apply_plain(plan, r), inner=3, calls=10)
            nbytes = neumann_bytes(plan, 1, r.element_size())
            bound_us = nbytes / HBM_BYTES_PER_S * 1e6
            print(f"K2 {name} n={plan.n} sweeps=6 reach={plan.reach} {str(dtype)[6:]}: "
                  f"max_rel_err {err:.3e} max_abs_err {abs_err:.3e}, repeats bitwise equal; "
                  f"device: K2 {t['ms'] * 1e3:.1f} us/apply ({nbytes / (t['ms'] * 1e-3) / 1e9:.0f} "
                  f"GB/s, {bound_us / (t['ms'] * 1e3):.1%} of the {bound_us:.1f} us bound), plain "
                  f"{t['plain_ms'] * 1e3:.1f} us/apply; issued from Python: K2 "
                  f"{t['host_ms'] * 1e3:.1f} us/apply, plain {t['plain_host_ms'] * 1e3:.1f} us/apply")
            # the JSON line's shape: 2.1M rows, 75 MB, out of the 50 MB L2
            if name == "ilu0 laplacian_3d(128)" and dtype == torch.float32:
                main = dict(max_abs_err=abs_err, **t)
            del plan
    return main


def true_relres(A, x, np):
    b = np.ones(A.shape[0])
    return float(np.linalg.norm(b - A.to_scipy() @ x.cpu().numpy()) / np.linalg.norm(b))


def timed_ir(lt, torch, dev, A, method, pc, opts):
    """solve_ir with b = 1: prepare_ir (setup), then two solves (cold,
    warm).  Returns (prepare_ir's tuple, x, info, setup s, [cold s, warm s])."""
    t0 = time.perf_counter()
    prep = lt.prepare_ir(A, method=method, pc=pc, device=dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.solve_ir(A, b, method=method, pc=pc, options=opts)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return prep, x, info, setup_s, runs


def ir_cg_ilu0(lt, torch, dev, A):
    """CG + ILU(0) through solve_ir to relres 1e-8 (phases 4 and 5)."""
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    return timed_ir(lt, torch, dev, A, "cg", "ilu0", opts)[1:]


def phase_main(lt, np, torch, dev, counters):
    A = lt.sparse.laplacian_3d(64)
    for fn in counters:
        fn.launches = 0
    x, info, setup_s, runs = ir_cg_ilu0(lt, torch, dev, A)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    print(f"main 64^3 solve_ir cg+ilu0: inner its {info.nits}, true relres {rr:.3e}, "
          f"setup {setup_s:.3f} s, solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s, "
          f"launches {launches}")
    check(rr <= 1e-8, f"64^3: true relres {rr:.3e} > 1e-8")
    check(info.nits <= 114, f"64^3: {info.nits} inner iterations > 114")
    for name, count in launches.items():
        check(count > 0, f"64^3: kernel {name} was never launched on the main path")
    # one K2 launch an apply, and CG applies the PC once an inner iteration:
    # exactly one launch an inner iteration over the two solves (the 2k
    # sweep launches gave 12)
    per_it = launches["fused_neumann_apply"] / (2 * info.nits)
    print(f"main 64^3: K2 {launches['fused_neumann_apply']} launches over 2 solves of "
          f"{info.nits} inner its, {per_it:.2f} an inner iteration")
    check(launches["fused_neumann_apply"] == 2 * info.nits,
          f"64^3: {per_it:.2f} K2 launches an inner iteration, not one an apply")
    return launches


def phase_128(lt, np, torch, dev):
    A = lt.sparse.laplacian_3d(128)
    x, info, setup_s, runs = ir_cg_ilu0(lt, torch, dev, A)
    rr = true_relres(A, x, np)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    prof = profiled(torch, lambda: lt.solve_ir(A, b, method="cg", pc="ilu0", options=opts),
                    info.nits, kernel="neumann_wavefront_kernel")
    print(f"main 128^3 solve_ir cg+ilu0: inner its {info.nits}, true relres {rr:.3e}, "
          f"setup {setup_s:.3f} s, solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s; {prof}")
    check(rr <= 1e-8, f"128^3: true relres {rr:.3e} > 1e-8")


def phase_exam(lt, np, torch, dev):
    """The reference example through ``python -m lssp_tpu_torch.examples.exam``'s
    ``main``: GMRES(60) + ILU(1) on the 2-D Laplacian N = 100, fp64 Solver."""
    from lssp_tpu_torch.examples import exam
    t0 = time.perf_counter()
    out = exam.main(["100", "--device", str(dev)])
    secs = time.perf_counter() - t0
    print(f"exam gmres(60)+iluk N=100 fp64 (lssp_tpu_torch.examples.exam): nits {out['nits']}, "
          f"residual {out['residual']:.8e}, verification {out['verification']:.8e}, "
          f"{secs:.3f} s")
    check(abs(out["nits"] - 49) <= 1, f"exam: {out['nits']} iterations, expected 49 +- 1")
    check(out["verification"] <= 2 * 8.18e-6,
          f"exam: verification residual {out['verification']:.3e} > {2 * 8.18e-6:.3e}")


def strayed_grid(lt, np, N, grid, dtype, seed=5):
    """``bench.py``'s HYB matrix recipe: the 2-D (or 3-D) Laplacian plus
    max(n//200, 8) entries of 0.01 at rows and columns drawn from
    default_rng(seed), summed into A (nonsymmetric)."""
    import scipy.sparse as sp
    gen = {"2d": lt.sparse.laplacian_2d, "3d": lt.sparse.laplacian_3d}[grid]
    S = gen(N, dtype=dtype).to_scipy().tocoo()
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    n_extra = max(n // 200, 8)
    r, c = rng.integers(0, n, n_extra), rng.integers(0, n, n_extra)
    E = sp.coo_matrix((np.full(n_extra, 0.01, dtype), (r, c)), shape=S.shape)
    return lt.CSR.from_scipy((S + E).tocsr())


def hyb_gbps(H, itemsize, ms):
    """GB/s under (ndiag·n + 2n)·itemsize + nnz_rem·(itemsize + 8)."""
    n = H.shape[0]
    nbytes = (len(H.dia.offsets) * n + 2 * n) * itemsize + H.nnz_rem * (itemsize + 8)
    return nbytes / (ms * 1e-3) / 1e9


def check_k3(torch, H, x, z, tol, name):
    """K3 against its plain version for the three epilogues; returns the
    (max rel err, max abs err) over them."""
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    worst = (0.0, 0.0)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (1.0, 1.0, z)):
        y = hyb_spmv(H, x, alpha=alpha, beta=beta, z=zz)
        ref = hyb_spmv_plain(H, x, alpha, beta, zz)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
        check(bool(torch.isfinite(y).all()), f"K3 {name}: non-finite output")
        check(err <= tol, f"K3 {name} alpha {alpha} beta {beta}: max rel err {err:.3e} "
              f"> {tol:.0e}")
        worst = (max(worst[0], err), max(worst[1], abs_err))
    return worst


def phase_k3(lt, np, torch, dev, card):
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(2)
    mtx = os.path.join(HERE, "benchmarks", "matrices", "coupled3d_25.mtx.gz")
    cases = [("bench laplacian_2d(2048)+strays",
              lambda dt: strayed_grid(lt, np, 2048, "2d", dt)),
             ("coupled3d_25", lambda dt: lt.sparse.read_matrix_market(mtx).astype(dt)),
             ("laplacian_2d(1021)+strays", lambda dt: strayed_grid(lt, np, 1021, "2d", dt))]
    for name, build in cases:
        for dtype in (torch.float32, torch.float64):
            A = build({torch.float32: np.float32, torch.float64: np.float64}[dtype])
            t0 = time.perf_counter()
            H = lt.sparse.csr_to_hyb(A, device=dev)
            hyb_s = time.perf_counter() - t0
            n = A.shape[0]
            x = torch.from_numpy(rng.uniform(-1, 1, n)).to(device=dev, dtype=dtype)
            z = torch.from_numpy(rng.uniform(-1, 1, n)).to(device=dev, dtype=dtype)
            err, abs_err = check_k3(torch, H, x, z, tol[dtype], name)
            t = timings(lambda: hyb_spmv(H, x), lambda: hyb_spmv_plain(H, x))
            print(f"K3 {name} n={n} ndiag={len(H.dia.offsets)} nnz_rem={H.nnz_rem} "
                  f"{str(dtype)[6:]} [{card}]: csr_to_hyb {hyb_s:.3f} s; max_rel_err "
                  f"{err:.3e} max_abs_err {abs_err:.3e}; device: K3 {t['ms'] * 1e3:.2f} us "
                  f"({hyb_gbps(H, x.element_size(), t['ms']):.1f} GB/s), plain "
                  f"{t['plain_ms'] * 1e3:.2f} us; issued from Python: K3 "
                  f"{t['host_ms'] * 1e3:.2f} us, plain {t['plain_host_ms'] * 1e3:.2f} us")
            del H, x, z


def check_path_kernels(lt, np, torch, dev, A32, M32, name):
    """Each kernel a solve_ir just ran, against its plain version at the
    fp32 shape that solve gave it: the matrix's SpMV (K1 on a DIA, K3 on a
    HYB) and the preconditioner's Neumann apply (K2, on its own plan,
    strays included), within 1e-5 max relative error.  Returns ({kernel:
    max abs err}, the random fp32 vector they were given)."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    from lssp_tpu_torch.ops.neumann import (FusedNeumann, fused_neumann_apply,
                                            neumann_apply_plain)
    v = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, A32.shape[0])).to(
        device=dev, dtype=torch.float32)
    if isinstance(A32, lt.HYB):
        pairs = {"hyb_spmv": (lambda: hyb_spmv(A32, v), lambda: hyb_spmv_plain(A32, v))}
    else:
        pairs = {"dia_spmv": (lambda: dia_spmv(A32, v),
                              lambda: dia_spmv_plain(A32.data, A32.offsets, v))}
    check(M32 is not None and isinstance(M32.state, FusedNeumann),
          f"{name}: the preconditioner has no K2 plan")
    pairs["neumann_sweep"] = (lambda: fused_neumann_apply(M32.state, v),
                              lambda: neumann_apply_plain(M32.state, v))
    out = {}
    for kname, (kernel, plain) in pairs.items():
        y, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
        check(bool(torch.isfinite(y).all()), f"{name}: {kname} non-finite output")
        check(err <= 1e-5, f"{name}: {kname} at the path's fp32 shape: max rel err "
              f"{err:.3e} > 1e-5")
        print(f"{name}: {kname} against its plain version at the path's fp32 shape: "
              f"max_rel_err {err:.3e} max_abs_err {abs_err:.3e}")
        out[kname] = abs_err
    return out, v


def phase_hyb_main(lt, np, torch, dev, counters, card):
    """The HYB path at a size users run: BiCGSTAB + ILU(0) through solve_ir
    on the 3-D Laplacian 128³ plus 10,485 strays."""
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    A = strayed_grid(lt, np, 128, "3d", np.float64)
    t0 = time.perf_counter()
    lt.sparse.csr_to_hyb(A)
    hyb_s = time.perf_counter() - t0
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=5000)
    for fn in counters:
        fn.launches = 0
    (_, A64, A32, _, M32), x, info, setup_s, runs = timed_ir(lt, torch, dev, A, "bicgstab",
                                                            "ilu0", opts)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    print(f"hyb 128^3+strays n={A.shape[0]} ndiag={len(A64.dia.offsets)} "
          f"nnz_rem={A64.nnz_rem} solve_ir bicgstab+ilu0 [{card}]: inner its {info.nits}, "
          f"true relres {rr:.3e}, setup {setup_s:.3f} s (csr_to_hyb alone {hyb_s:.3f} s), "
          f"solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s, launches {launches}")
    check(rr <= 1e-8, f"hyb 128^3: true relres {rr:.3e} > 1e-8")
    check(isinstance(A64, lt.HYB) and isinstance(A32, lt.HYB),
          f"hyb 128^3: to_device_format gave {type(A64).__name__}, not HYB")
    check(M32.state.L.stray_ptr is not None or M32.state.U.stray_ptr is not None,
          "hyb 128^3: the K2 plan has no strays")
    for name in ("hyb_spmv", "fused_neumann_apply"):
        check(launches[name] > 0, f"hyb 128^3: kernel {name} was never launched")
    errs, x32 = check_path_kernels(lt, np, torch, dev, A32, M32, "hyb 128^3")
    t = timings(lambda: hyb_spmv(A32, x32), lambda: hyb_spmv_plain(A32, x32))
    print(f"K3 at the hyb 128^3 fp32 shape [{card}]: device: K3 {t['ms'] * 1e3:.2f} us "
          f"({hyb_gbps(A32, 4, t['ms']):.1f} GB/s), plain {t['plain_ms'] * 1e3:.2f} us; issued from Python: K3 {t['host_ms'] * 1e3:.2f} us, "
          f"plain {t['plain_host_ms'] * 1e3:.2f} us")
    return launches, dict(max_abs_err=errs["hyb_spmv"], **t)


def phase_acceptance(lt, np, torch, dev, counters, card, name, method, pc, restart, limit,
                     fmt):
    """An acceptance config of benchmarks/acceptance.py on its vendored
    matrix: solve_ir, b = 1, relres 1e-8, maxit 5000."""
    A = lt.sparse.read_matrix_market(os.path.join(HERE, "benchmarks", "matrices",
                                                  name + ".mtx.gz"))
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=5000, restart=restart)
    for fn in counters:
        fn.launches = 0
    (_, A64, A32, _, M32), x, info, setup_s, runs = timed_ir(lt, torch, dev, A, method, pc,
                                                             opts)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    print(f"acceptance {method}+{pc} {name} n={A.shape[0]} ({type(A64).__name__}) [{card}]: "
          f"inner its {info.nits} (limit {limit}), true relres {rr:.3e}, setup {setup_s:.3f} s, "
          f"solve cold {runs[0]:.3f} s, warm {runs[1]:.3f} s, launches {launches}")
    check(type(A64).__name__ == fmt, f"{name}: format {type(A64).__name__}, expected {fmt}")
    check(info.nits <= limit, f"{name}: {info.nits} inner iterations > {limit}")
    check(rr <= 1e-8, f"{name}: true relres {rr:.3e} > 1e-8")
    kernel = {"HYB": "hyb_spmv", "DIA": "dia_spmv"}[fmt]
    check(launches[kernel] > 0, f"{name}: kernel {kernel} was never launched")
    check_path_kernels(lt, np, torch, dev, A32, M32, name)


def ext_gbps(M, itemsize, ms, with_z=False):
    """GB/s under P·(ndiag·R + (R+lo+hi) + R [+ R with z])·itemsize."""
    P, R = M.nshards, M.rows_per_shard
    nbytes = P * (len(M.offsets) * R + (R + M.lo + M.hi) + R + (R if with_z else 0)) * itemsize
    return nbytes / (ms * 1e-3) / 1e9


def check_k4(torch, M, x_ext, z, tol, name):
    """K4 against its plain version for the product (1, 0) and the sweep
    epilogue (−1, 1, z); returns the (max rel err, max abs err) over both."""
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmv_ext, dia_spmv_ext_plain
    worst = (0.0, 0.0)
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, z)):
        y = dia_spmv_ext(M.data, M.offsets, x_ext, alpha, beta, zz, offsets_t=M.offsets_t)
        ref = dia_spmv_ext_plain(M.data, M.offsets, x_ext, alpha, beta, zz)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
        check(bool(torch.isfinite(y).all()), f"K4 {name}: non-finite output")
        check(err <= tol, f"K4 {name} alpha {alpha} beta {beta}: max rel err {err:.3e} "
              f"> {tol:.0e}")
        worst = (max(worst[0], err), max(worst[1], abs_err))
    return worst


def phase_k4(lt, np, torch, dev, card):
    """K4 alone on 128³ and a 1000² Laplacian over 8 shards (R = 262,144
    and 125,000, the latter not a multiple of the 256-row block): against
    its plain version, and the distributed product (halo exchange, then
    K4) against K1 on the same matrix unpartitioned."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmv_ext, dia_spmv_ext_plain
    from lssp_tpu_torch.parallel import halo_exchange, make_dist_spmv, partition_csr_dia
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(4)
    for name, A in (("laplacian_3d(128)", lt.sparse.laplacian_3d(128)),
                    ("laplacian_2d(1000)", lt.sparse.laplacian_2d(1000))):
        M64 = partition_csr_dia(A, 8).to(dev)
        D64 = lt.sparse.csr_to_dia(A, device=dev)
        n = A.shape[0]
        P, R = M64.nshards, M64.rows_per_shard
        for dtype in (torch.float32, torch.float64):
            M, D = M64.to(dtype=dtype), D64.to(dtype=dtype)
            x = torch.from_numpy(rng.uniform(-1, 1, n)).to(device=dev, dtype=dtype)
            z = torch.from_numpy(rng.uniform(-1, 1, (P, R))).to(device=dev, dtype=dtype)
            x_ext = halo_exchange(x.view(P, R), M.lo, M.hi)
            err, abs_err = check_k4(torch, M, x_ext, z, tol[dtype], name)
            y, ref = make_dist_spmv(M)(x), dia_spmv(D, x)
            torch.cuda.synchronize()
            err_k1 = rel_err(y, ref)
            check(err_k1 <= tol[dtype], f"K4 {name} {dtype}: distributed product against K1: "
                  f"max rel err {err_k1:.3e} > {tol[dtype]:.0e}")
            t = timings(lambda: dia_spmv_ext(M.data, M.offsets, x_ext, offsets_t=M.offsets_t),
                        lambda: dia_spmv_ext_plain(M.data, M.offsets, x_ext))
            t_sweep = graph_ms(lambda: dia_spmv_ext(M.data, M.offsets, x_ext, -1.0, 1.0, z,
                                                    offsets_t=M.offsets_t))
            k1_ms = graph_ms(lambda: dia_spmv(D, x))
            halo_ms = graph_ms(lambda: halo_exchange(x.view(P, R), M.lo, M.hi))
            isz = x.element_size()
            print(f"K4 {name} P={P} R={R} ndiag={len(M.offsets)} lo={M.lo} hi={M.hi} "
                  f"{str(dtype)[6:]} [{card}]: max_rel_err {err:.3e} max_abs_err {abs_err:.3e}, "
                  f"against K1 {err_k1:.3e}; device: K4 {t['ms'] * 1e3:.2f} us "
                  f"({ext_gbps(M, isz, t['ms']):.1f} GB/s), sweep epilogue "
                  f"{t_sweep * 1e3:.2f} us ({ext_gbps(M, isz, t_sweep, True):.1f} GB/s), plain "
                  f"{t['plain_ms'] * 1e3:.2f} us, K1 on the same band {k1_ms * 1e3:.2f} us, "
                  f"halo exchange {halo_ms * 1e3:.2f} us; issued from Python: K4 "
                  f"{t['host_ms'] * 1e3:.2f} us, plain {t['plain_host_ms'] * 1e3:.2f} us")
            del M, D, x, z, x_ext


def timed_dist_ir(lt, np, torch, dev, A, method, pc, counters, runs=5):
    """dist_solve_ir over 8 shards on the card, b = 1, relres 1e-8: the
    first call (setup included) and ``runs`` warm ones, every launch counter
    reset just before.  Returns (x, info, first s, [warm s], launches, the
    prepared state)."""
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, maxit=5000)
    for fn in counters:
        fn.launches = 0
    walls, its = [], []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.dist_solve_ir(A, b, method=method, pc=pc, mesh=mesh, options=opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        its.append(info.nits)
    launches = {fn.__name__: fn.launches for fn in counters}
    check(len(set(its)) == 1, f"dist_solve_ir {method}+{pc}: inner iterations {its} differ "
          "between runs")
    (prep,) = A._dist_cache.values()
    return x, info, walls[0], walls[1:], launches, prep


def check_dist_path(lt, np, torch, dev, prep, name):
    """K4 against its plain version on a distributed solve's own fp32
    partition (its band for a DistHYB) and, when it has one, its per-shard
    Neumann factors, within 1e-5.  Returns (max abs err, the partition's
    band, the halo-exchanged vector it was given)."""
    import torch.nn.functional as F
    from lssp_tpu_torch.parallel import DistHYB, halo_exchange
    M = prep["M"].band if isinstance(prep["M"], DistHYB) else prep["M"]
    check(M.data.dtype == torch.float32, f"{name}: the inner partition is {M.data.dtype}")
    P, R = M.nshards, M.rows_per_shard
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.uniform(-1, 1, (P, R))).to(device=dev, dtype=torch.float32)
    x_ext = halo_exchange(v, M.lo, M.hi)
    bands = [("partition", M, x_ext)]
    if prep["kind"] == "ilu_nm":
        st = prep["pc_state"]
        bands += [(f"Neumann {f}", T, F.pad(v, (T.lo, T.hi))) for f, T in (("L", st.L),
                                                                            ("U", st.U))]
    worst = 0.0
    for bname, T, xe in bands:
        err, abs_err = check_k4(torch, T, xe, v, 1e-5, f"{name} {bname}")
        print(f"{name}: K4 against its plain version on the {bname} band (ndiag "
              f"{len(T.offsets)}, lo {T.lo}, hi {T.hi}), fp32: max_rel_err {err:.3e} "
              f"max_abs_err {abs_err:.3e}")
        worst = max(worst, abs_err)
    return worst, M, x_ext


def report_dist(name, A, info, rr, first, warm, launches, card):
    print(f"{name} n={A.shape[0]} over 8 shards [{card}]: inner its {info.nits}, true relres "
          f"{rr:.3e}, first call (setup included) {first:.3f} s, setup about "
          f"{first - min(warm):.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"launches {launches}")


def check_only_k4(launches, name):
    check(launches["dia_spmv_ext"] > 0, f"{name}: kernel dia_spmv_ext was never launched")
    for other in ("dia_spmv", "fused_neumann_apply", "hyb_spmv"):
        check(launches[other] == 0, f"{name}: kernel {other} launched {launches[other]} times "
              "on the distributed path")


def phase_dist_main(lt, np, torch, dev, counters, card):
    """The slice's main path: dist_solve_ir, CG + ILU(0) with the default 6
    sweeps, on 128³ over 8 shards of one card."""
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmv_ext, dia_spmv_ext_plain
    A = lt.sparse.laplacian_3d(128)
    x, info, first, warm, launches, prep = timed_dist_ir(lt, np, torch, dev, A, "cg", "ilu0",
                                                         counters)
    rr = true_relres(A, x, np)
    report_dist("dist 128^3 dist_solve_ir cg+ilu0", A, info, rr, first, warm, launches, card)
    check(prep["kind"] == "ilu_nm", f"dist 128^3: preconditioner kind {prep['kind']}")
    check(194 <= info.nits <= 262, f"dist 128^3: {info.nits} inner iterations outside "
          "[194, 262]")
    check(rr <= 1e-8, f"dist 128^3: true relres {rr:.3e} > 1e-8")
    check_only_k4(launches, "dist 128^3")
    abs_err, M, x_ext = check_dist_path(lt, np, torch, dev, prep, "dist 128^3")
    t = timings(lambda: dia_spmv_ext(M.data, M.offsets, x_ext, offsets_t=M.offsets_t),
                lambda: dia_spmv_ext_plain(M.data, M.offsets, x_ext))
    print(f"K4 at the dist 128^3 fp32 partition [{card}]: device: K4 {t['ms'] * 1e3:.2f} us "
          f"({ext_gbps(M, 4, t['ms']):.1f} GB/s), plain {t['plain_ms'] * 1e3:.2f} us; issued "
          f"from Python: K4 {t['host_ms'] * 1e3:.2f} us, plain {t['plain_host_ms'] * 1e3:.2f} us")
    return launches, dict(max_abs_err=abs_err, **t)


def phase_dist_hyb(lt, np, torch, dev, counters, card):
    """The DistHYB path: dist_solve_ir, BiCGSTAB + Jacobi, on the 128³
    Laplacian plus 10,485 strays over 8 shards."""
    from lssp_tpu_torch.parallel import DistHYB, partition_matrix
    A = strayed_grid(lt, np, 128, "3d", np.float64)
    t0 = time.perf_counter()
    M = partition_matrix(A, 8)
    part_s = time.perf_counter() - t0
    check(isinstance(M, DistHYB), f"dist hyb: partition_matrix gave {type(M).__name__}")
    x, info, first, warm, launches, prep = timed_dist_ir(lt, np, torch, dev, A, "bicgstab",
                                                         "jacobi", counters)
    rr = true_relres(A, x, np)
    report_dist(f"dist hyb 128^3+strays (band {len(M.band.offsets)} diags, remainder "
                f"{tuple(M.rem_vals.shape)}, partition_matrix {part_s:.3f} s) dist_solve_ir "
                "bicgstab+jacobi", A, info, rr, first, warm, launches, card)
    # an upper bound only, JAX's 454 + 15 %: BiCGSTAB's count here moves
    # with the rounding of the reductions (355-428 on this card and the CPU
    # for one, eight shards and one device), so a lower bound tests nothing
    check(info.nits <= 522, f"dist hyb: {info.nits} inner iterations > 522")
    check(rr <= 1e-8, f"dist hyb: true relres {rr:.3e} > 1e-8")
    check(isinstance(prep["M"], DistHYB), "dist hyb: the solve's partition is not DistHYB")
    check_only_k4(launches, "dist hyb")
    check_dist_path(lt, np, torch, dev, prep, "dist hyb")


def check_krhs(torch, name, form, plain, singles, tol):
    """A k-rhs form against its plain version and against the stacked
    results of k single-rhs launches (last axis = the columns); returns
    (max rel err vs plain, max abs err vs plain, max rel err vs singles)."""
    y, ref, one = form(), plain(), torch.stack(singles(), dim=-1)
    torch.cuda.synchronize()
    err, abs_err, err1 = rel_err(y, ref), (y - ref).abs().max().item(), rel_err(y, one)
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    check(err <= tol, f"{name}: max rel err {err:.3e} against its plain version > {tol:.0e}")
    check(err1 <= tol, f"{name}: max rel err {err1:.3e} against k single launches > {tol:.0e}")
    return err, abs_err, err1


def time_krhs(form, plain, singles, calls=10):
    """Device ms per call of the k-rhs form, its plain version and k single
    launches (one call = all k)."""
    return dict(ms=graph_ms(form, calls), plain_ms=graph_ms(plain, calls),
                singles_ms=graph_ms(singles, calls))


def report_krhs(name, card, err, abs_err, err1, t, nbytes):
    print(f"{name} [{card}]: max_rel_err {err:.3e} (vs plain) {err1:.3e} (vs k single "
          f"launches) max_abs_err {abs_err:.3e}; device: form {t['ms'] * 1e3:.2f} us "
          f"({nbytes / (t['ms'] * 1e-3) / 1e9:.1f} GB/s), plain {t['plain_ms'] * 1e3:.2f} us, "
          f"k single launches {t['singles_ms'] * 1e3:.2f} us")


def columns(X):
    """The k columns of a block (last axis), each contiguous."""
    return [X[..., c].contiguous() for c in range(X.shape[-1])]


def phase_krhs(lt, np, torch, dev, card):
    """Phase 14: K1k-K4k alone at the multi-rhs path's shapes."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain, dia_spmv
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmm_ext_plain, dia_spmv_ext
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain, hyb_spmv
    from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                            neumann_block_apply, plan_fused_neumann)
    from lssp_tpu_torch.parallel import halo_exchange, partition_csr_dia
    from lssp_tpu_torch.pc.ilu_host import iluk_factor
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(14)
    A = lt.sparse.laplacian_3d(128)
    n = A.shape[0]
    D64 = lt.sparse.csr_to_dia(A, device=dev)
    nd = len(D64.offsets)
    out = {}
    for dtype in (torch.float32, torch.float64):
        D = D64.to(dtype=dtype)
        for k in (1, 4, 8):
            X = torch.from_numpy(rng.uniform(-1, 1, (n, k))).to(device=dev, dtype=dtype)
            cols = columns(X)
            form = lambda: dia_spmm(D, X)
            plain = lambda: dia_spmm_plain(D.data, D.offsets, X)
            singles = lambda: [dia_spmv(D, x) for x in cols]
            err, abs_err, err1 = check_krhs(torch, "K1k", form, plain, singles, tol[dtype])
            t = time_krhs(form, plain, singles)
            report_krhs(f"K1k laplacian_3d(128) n={n} ndiag={nd} k={k} {str(dtype)[6:]}", card,
                        err, abs_err, err1, t, (nd * n + 2 * k * n) * X.element_size())
            if dtype == torch.float32 and k == 8:
                out["dia_spmm"] = dict(max_abs_err=abs_err, **t)
            del X, cols
    k = 8
    A32 = strayed_grid(lt, np, 128, "3d", np.float64)
    H = lt.sparse.csr_to_hyb(A32, device=dev).to(dtype=torch.float32)
    X = torch.from_numpy(rng.uniform(-1, 1, (n, k))).to(device=dev, dtype=torch.float32)
    cols = columns(X)
    form, plain = lambda: hyb_spmm(H, X), lambda: hyb_spmm_plain(H, X)
    singles = lambda: [hyb_spmv(H, x) for x in cols]
    err, abs_err, err1 = check_krhs(torch, "K3k", form, plain, singles, 1e-5)
    t = time_krhs(form, plain, singles)
    nbytes = (len(H.dia.offsets) * n + 2 * k * n) * 4 + H.nnz_rem * (4 + 8)
    report_krhs(f"K3k hyb 128^3+strays nnz_rem={H.nnz_rem} k={k} float32", card, err, abs_err,
                err1, t, nbytes)
    out["hyb_spmm"] = dict(max_abs_err=abs_err, **t)
    del H
    L, U = iluk_factor(A, level=0)
    plan = plan_fused_neumann(L, U, 6, dtype=torch.float32, device=dev)
    form, plain = lambda: neumann_block_apply(plan, X), lambda: neumann_apply_plain(plan, X)
    singles = lambda: [fused_neumann_apply(plan, x) for x in cols]
    err, abs_err, err1 = check_krhs(torch, "K2k", form, plain, singles, 1e-5)
    check(repeat_equal(torch, form, form(), 5), "K2k: repeated applies differ")
    t = time_krhs(form, plain, singles, calls=5)
    nbytes = neumann_bytes(plan, k, 4)
    report_krhs(f"K2k ilu0 laplacian_3d(128) sweeps=6 k={k} float32 (per apply, "
                f"{nbytes / HBM_BYTES_PER_S * 1e6 / (t['ms'] * 1e3):.1%} of the "
                f"{nbytes / HBM_BYTES_PER_S * 1e6:.1f} us bound; repeats bitwise equal)", card,
                err, abs_err, err1, t, nbytes)
    out["neumann_sweep_block"] = dict(max_abs_err=abs_err, **t)
    del plan
    # K2k's other cases: fp64, an odd k (tile width 1), the adversarial plan
    for name, (Lc, Uc), dtype, kc in (
            ("ilu0 laplacian_3d(128)", (L, U), torch.float64, 8),
            ("ilu0 laplacian_3d(128)", (L, U), torch.float32, 3),
            ("adversarial ilu0-pattern laplacian_3d(128)", adversarial_factors(lt, np, A),
             torch.float32, 8)):
        plan = plan_fused_neumann(Lc, Uc, 6, dtype=dtype, device=dev)
        Xc = torch.from_numpy(rng.standard_normal((n, kc))).to(device=dev, dtype=dtype)
        ccols = columns(Xc)
        form = lambda: neumann_block_apply(plan, Xc)
        err, abs_err, err1 = check_krhs(
            torch, f"K2k {name} k={kc}", form, lambda: neumann_apply_plain(plan, Xc),
            lambda: [fused_neumann_apply(plan, x) for x in ccols], tol[dtype])
        check(repeat_equal(torch, form, form(), 50 if "adversarial" in name else 5),
              f"K2k {name} k={kc}: repeated applies differ")
        ms = graph_ms(form, calls=5)
        nbytes = neumann_bytes(plan, kc, Xc.element_size())
        print(f"K2k {name} sweeps=6 k={kc} {str(dtype)[6:]} [{card}]: max_rel_err {err:.3e} "
              f"(vs plain) {err1:.3e} (vs k single launches) max_abs_err {abs_err:.3e}, repeats "
              f"bitwise equal; device {ms * 1e3:.1f} us ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{nbytes / HBM_BYTES_PER_S * 1e6 / (ms * 1e3):.1%} of the bound)")
        out["neumann_sweep_block"]["max_abs_err"] = max(out["neumann_sweep_block"]["max_abs_err"],
                                                        abs_err if dtype == torch.float32 else 0.0)
        del plan, Xc, ccols
    M = partition_csr_dia(A, 8).to(device=dev, dtype=torch.float32)
    P, R = M.nshards, M.rows_per_shard
    x_ext = halo_exchange(X.view(P, R, k), M.lo, M.hi)
    ext_cols = columns(x_ext)
    form = lambda: dia_spmm_ext(M.data, M.offsets, x_ext, offsets_t=M.offsets_t)
    plain = lambda: dia_spmm_ext_plain(M.data, M.offsets, x_ext)
    singles = lambda: [dia_spmv_ext(M.data, M.offsets, x, offsets_t=M.offsets_t)
                       for x in ext_cols]
    err, abs_err, err1 = check_krhs(torch, "K4k", form, plain, singles, 1e-5)
    t = time_krhs(form, plain, singles)
    nbytes = P * (len(M.offsets) * R + k * (R + M.lo + M.hi) + k * R) * 4
    report_krhs(f"K4k laplacian_3d(128) P={P} R={R} lo={M.lo} hi={M.hi} k={k} float32", card,
                err, abs_err, err1, t, nbytes)
    out["dist_spmm_ext"] = dict(max_abs_err=abs_err, **t)
    return out


def block_relres(A, X, B, np):
    """Each column's true relative residual, recomputed with scipy."""
    Bh, Xh = B.cpu().numpy(), X.cpu().numpy()
    return np.linalg.norm(Bh - A.to_scipy() @ Xh, axis=0) / np.linalg.norm(Bh, axis=0)


def serving_block(np, torch, dev, n, k=8):
    return torch.from_numpy(np.random.default_rng(0).standard_normal((n, k))).to(dev)


def check_block_kernels(lt, torch, A_dev, M, V, tol, name):
    """The k-rhs kernels a multi solve just ran, on its own matrix (K1k on
    a DIA, K3k on a HYB) and its own Neumann plan (K2k, strays included),
    with the block V: each against its plain version and against k
    single-rhs launches on V's columns, within ``tol``.  Returns {kernel:
    max abs err against plain}."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain, dia_spmv
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain, hyb_spmv
    from lssp_tpu_torch.ops.neumann import (FusedNeumann, fused_neumann_apply,
                                            neumann_apply_plain, neumann_block_apply)
    cols = columns(V)
    if isinstance(A_dev, lt.HYB):
        pairs = {"hyb_spmm": (lambda: hyb_spmm(A_dev, V), lambda: hyb_spmm_plain(A_dev, V),
                              lambda: [hyb_spmv(A_dev, x) for x in cols])}
    else:
        pairs = {"dia_spmm": (lambda: dia_spmm(A_dev, V),
                              lambda: dia_spmm_plain(A_dev.data, A_dev.offsets, V),
                              lambda: [dia_spmv(A_dev, x) for x in cols])}
    check(M is not None and isinstance(M.state, FusedNeumann),
          f"{name}: the preconditioner has no K2 plan")
    pairs["neumann_sweep_block"] = (lambda: neumann_block_apply(M.state, V),
                                    lambda: neumann_apply_plain(M.state, V),
                                    lambda: [fused_neumann_apply(M.state, x) for x in cols])
    out = {}
    for kname, (form, plain, singles) in pairs.items():
        err, abs_err, err1 = check_krhs(torch, f"{name}: {kname}", form, plain, singles, tol)
        print(f"{name}: {kname} on the solve's own {str(V.dtype)[6:]} "
              f"{'plan' if kname == 'neumann_sweep_block' else 'matrix'}, k={V.shape[1]}: "
              f"max_rel_err {err:.3e} (vs plain) {err1:.3e} (vs k single launches) "
              f"max_abs_err {abs_err:.3e}")
        out[kname] = abs_err
    return out


def check_only(launches, allowed, name):
    """Every counter outside ``allowed`` stayed at 0, and every one in it moved."""
    for kname, count in launches.items():
        if kname in allowed:
            check(count > 0, f"{name}: kernel {kname} was never launched")
        else:
            check(count == 0, f"{name}: kernel {kname} launched {count} times")


def phase_serving(lt, np, torch, dev, counters, card):
    """Phase 15: the serving path, solve_ir_multi blockcg + ILU(0) on 128³,
    k = 8, against 8 sequential solve_ir cg + ILU(0) on the same columns."""
    A = lt.sparse.laplacian_3d(128)
    B = serving_block(np, torch, dev, A.shape[0])
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    for fn in counters:
        fn.launches = 0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = lt.solve_ir_multi(A, B, method="blockcg", pc="ilu0", options=opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            launches = {fn.__name__: fn.launches for fn in counters}
    rr = block_relres(A, X, B, np)
    seq = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles = [lt.solve_ir(A, B[:, c], method="cg", pc="ilu0", options=opts)
                   for c in range(B.shape[1])]
        torch.cuda.synchronize()
        seq.append(time.perf_counter() - t0)
    warm = min(walls[1:])
    prof = profiled(torch, lambda: lt.solve_ir_multi(A, B, method="blockcg", pc="ilu0",
                                                     options=opts), info.nits,
                    kernel="neumann_wavefront_kernel")
    print(f"serving 128^3 solve_ir_multi blockcg+ilu0 k=8 [{card}]: {prof}")
    print(f"serving 128^3 solve_ir_multi blockcg+ilu0 k=8 [{card}]: inner its {info.nits} "
          f"(max {info.nits.max()}), true relres max {rr.max():.3e}, first call (setup "
          f"included) {walls[0]:.3f} s, warm {', '.join(f'{w:.3f}' for w in walls[1:])} s; "
          f"8 sequential solve_ir cg+ilu0: {', '.join(f'{w:.3f}' for w in seq)} s (inner its "
          f"{[s[1].nits for s in singles]}); ratio {min(seq) / warm:.2f}; launches of the first "
          f"call {launches}")
    check((rr <= 1e-8).all(), f"serving: true relres {rr} > 1e-8")
    check(info.nits.max() <= 390, f"serving: {info.nits.max()} inner iterations > 390")
    check_only(launches, {"dia_spmm", "neumann_block_apply"}, "serving")
    # block CG applies the PC once a step for all 8 columns: one K2k launch;
    # a refinement round runs as many steps as its slowest column, so the
    # rounds add a few launches past the slowest column's total
    per_it = launches["neumann_block_apply"] / int(info.nits.max())
    print(f"serving: K2k {launches['neumann_block_apply']} launches over "
          f"{int(info.nits.max())} inner its, {per_it:.2f} an inner iteration")
    check(per_it <= 1.05,
          f"serving: {per_it:.2f} K2k launches an inner iteration, not one an apply")
    _, _, A32, _, M32 = lt.prepare_ir(A, method="blockcg", pc="ilu0", device=dev)
    errs = check_block_kernels(lt, torch, A32, M32, B.to(torch.float32), 1e-5, "serving")
    return launches, errs


def phase_per_column(lt, np, torch, dev, counters):
    """Phase 16: solve_multi cg + ILU(0), fp64, 64³, k = 4 against each
    column's own solve; then K1k and K2k checked on that solve's own fp64
    matrix and plan (rebuilt by the same setup through the Solver)."""
    A = lt.sparse.laplacian_3d(64)
    B = serving_block(np, torch, dev, A.shape[0], k=4)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    for fn in counters:
        fn.launches = 0
    X, info = lt.solve_multi(A, B, method="cg", pc="ilu0", options=opts)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    singles = [lt.solve(A, B[:, c], method="cg", pc="ilu0", options=opts) for c in range(4)]
    dx = [(torch.linalg.vector_norm(X[:, c] - x) / torch.linalg.vector_norm(x)).item()
          for c, (x, _) in enumerate(singles)]
    its = [i.nits for _, i in singles]
    print(f"per-column 64^3 solve_multi cg+ilu0 fp64 k=4: nits {info.nits}, single solves "
          f"{its}, x rel diff {max(dx):.3e}, launches {launches}")
    check((np.abs(info.nits - np.array(its)) <= 1).all(),
          f"per-column: counts {info.nits} against single solves {its}")
    check(max(dx) <= 1e-8, f"per-column: x differs from the single solves by {max(dx):.3e}")
    check_only(launches, {"dia_spmm", "neumann_block_apply"}, "per-column")
    S = lt.Solver(method="cg", pc="ilu0", device=dev).assemble(A)
    check(S.dtype == torch.float64, f"per-column: the solve's system is {S.dtype}")
    return check_block_kernels(lt, torch, S.A_dev, S.M, B, 1e-12, "per-column")


def phase_hyb_multi(lt, np, torch, dev, counters, card):
    """Phase 17: solve_ir_multi blockgmres + ILU(1) on coupled3d_25 (HYB);
    then K3k and K2k checked on that solve's own fp32 matrix and plan."""
    A = lt.sparse.read_matrix_market(os.path.join(HERE, "benchmarks", "matrices",
                                                  "coupled3d_25.mtx.gz"))
    B = serving_block(np, torch, dev, A.shape[0], k=4)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=5000)
    for fn in counters:
        fn.launches = 0
    X, info = lt.solve_ir_multi(A, B, method="blockgmres", pc="iluk", options=opts)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = block_relres(A, X, B, np)
    _, A64, A32, _, M32 = lt.prepare_ir(A, method="blockgmres", pc="iluk", device=dev)
    print(f"hyb multi coupled3d_25 n={A.shape[0]} ({type(A64).__name__}) solve_ir_multi "
          f"blockgmres+iluk k=4 [{card}]: inner its {info.nits}, true relres max {rr.max():.3e}, "
          f"launches {launches}")
    check(isinstance(A64, lt.HYB), f"hyb multi: format {type(A64).__name__}, not HYB")
    check((rr <= 1e-8).all(), f"hyb multi: true relres {rr} > 1e-8")
    check_only(launches, {"hyb_spmm", "neumann_block_apply"}, "hyb multi")
    errs = check_block_kernels(lt, torch, A32, M32, B.to(torch.float32), 1e-5, "hyb multi")
    return launches, errs


def phase_dist_multi(lt, np, torch, dev, counters, card):
    """Phase 18: dist_solve_ir_multi blockcg + ILU(0) on 128³ over 8 shards,
    k = 8; K4k checked on the solve's own partition and factors."""
    import torch.nn.functional as F
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmm_ext_plain, dia_spmv_ext
    from lssp_tpu_torch.parallel import halo_exchange
    A = lt.sparse.laplacian_3d(128)
    B = serving_block(np, torch, dev, A.shape[0])
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, maxit=2000)
    for fn in counters:
        fn.launches = 0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = lt.dist_solve_ir_multi(A, B, method="blockcg", pc="ilu0", mesh=mesh,
                                         options=opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            launches = {fn.__name__: fn.launches for fn in counters}
    rr = block_relres(A, X, B, np)
    print(f"dist multi 128^3 dist_solve_ir_multi blockcg+ilu0 k=8 over 8 shards [{card}]: "
          f"inner its {info.nits} (max {info.nits.max()}), true relres max {rr.max():.3e}, "
          f"first call (setup included) {walls[0]:.3f} s, warm {walls[1]:.3f} s, launches of "
          f"the first call {launches}")
    check((rr <= 1e-8).all(), f"dist multi: true relres {rr} > 1e-8")
    check(info.nits.max() <= 434, f"dist multi: {info.nits.max()} inner iterations > 434")
    check_only(launches, {"dia_spmm_ext"}, "dist multi")
    (prep,) = A._dist_cache.values()
    check(prep["kind"] == "ilu_nm", f"dist multi: preconditioner kind {prep['kind']}")
    M, st = prep["M"], prep["pc_state"]
    P, R = M.nshards, M.rows_per_shard
    V = B.to(torch.float32).view(P, R, -1)
    v_cols = columns(V)
    worst = 0.0
    for bname, T, xe in (("partition", M, halo_exchange(V, M.lo, M.hi)),
                         ("Neumann L", st.L, F.pad(V, (0, 0, st.L.lo, st.L.hi))),
                         ("Neumann U", st.U, F.pad(V, (0, 0, st.U.lo, st.U.hi)))):
        xe_cols = columns(xe)
        for alpha, beta, z in ((1.0, 0.0, None), (-1.0, 1.0, V)):
            form = lambda: dia_spmm_ext(T.data, T.offsets, xe, alpha, beta, z,
                                        offsets_t=T.offsets_t)
            plain = lambda: dia_spmm_ext_plain(T.data, T.offsets, xe, alpha, beta, z)
            singles = lambda: [dia_spmv_ext(T.data, T.offsets, x, alpha, beta,
                                            None if z is None else zc, offsets_t=T.offsets_t)
                               for x, zc in zip(xe_cols, v_cols)]
            err, abs_err, err1 = check_krhs(torch, f"dist multi: K4k on the {bname} band "
                                            f"(alpha {alpha}, beta {beta})", form, plain,
                                            singles, 1e-5)
            print(f"dist multi: K4k on the solve's {bname} band (ndiag {len(T.offsets)}), "
                  f"alpha {alpha} beta {beta}, k=8, fp32: max_rel_err {err:.3e} (vs plain) "
                  f"{err1:.3e} (vs k single launches) max_abs_err {abs_err:.3e}")
            worst = max(worst, abs_err)
    return launches, worst


# ---------------------------------------------------------------------------
# AMG (phases 19-22)
# ---------------------------------------------------------------------------

# JAX's inner iteration counts on the CPU for the phases' systems
# (scripts/jax_amg_reference.py; phase 22: the largest column's)
JAX_CPU_NITS = {20: 11, 21: 13, 22: 9}


def count_limit(ref):
    """A reference count + 15 %, at least one iteration more."""
    return max(ref + 1, int(ref * 1.15))


def profile_solve(torch, fn):
    """One call of ``fn`` under torch.profiler: (profiled wall s, device-busy
    share of that wall (the union of the device's kernel and copy
    intervals), device launches, the six kernels with the most device time
    as {name: ms}, every kernel's device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        # a host range mirrored on the device's timeline (the program's
        # lssp.* spans) repeats the kernels under it: no operation of its own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            # the kernel's own name, without its namespace and template
            short = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            short = short.split("<")[0].split("(")[0].split("::")[-1]
            by_name[short] = by_name.get(short, 0.0) + (e.time_range.end - e.time_range.start)
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (wall, busy * 1e-6 / wall, len(spans), {k: round(v * 1e-3, 3) for k, v in top[:6]},
            {k: v * 1e-3 for k, v in top})


def profiled(torch, fn, nits, kernel=None):
    """``profile_solve`` of one more warm solve, as a line of text; with
    ``kernel`` (a kernel's short name) also its share of the device time."""
    wall, busy, launches, top, every = profile_solve(torch, fn)
    share = (f", {kernel} {every.get(kernel, 0.0) / max(sum(every.values()), 1e-12):.1%} of the "
             "device time" if kernel else "")
    return (f"profiled warm solve {wall:.3f} s, device busy {busy:.1%}, {launches} device "
            f"launches ({launches / max(int(max(nits) if hasattr(nits, '__len__') else nits), 1):.1f} "
            f"per inner iteration){share}, device ms by kernel {top}")


def level_table(levels, names=("A", "B", "C")):
    """Each level's rows, and each operator's format and diagonal count."""
    rows = []
    for i, lev in enumerate(levels):
        parts = []
        for nm in names:
            M = getattr(lev, nm, None)
            if M is None:
                continue
            kind = type(M).__name__
            nd = (len(M.offsets) if kind == "DIA" else len(M.dia.offsets) if kind == "HYB"
                  else M.data.shape[1])
            parts.append(f"{nm} {kind}({nd})")
        rows.append(f"L{i} n={lev.A.shape[0]} " + " ".join(parts))
    return "; ".join(rows)


def check_level_kernels(lt, np, torch, dev, levels, name, names=("A", "B", "C")):
    """K1 (on a DIA) and K3 (on a HYB) against their plain versions on every
    level operator of a hierarchy, in its dtype and in the other one of
    fp32 / fp64 (1e-5 / 1e-12).  Returns {kernel: max abs err} and the
    number of operators checked."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(19)
    worst, count = {}, 0
    for i, lev in enumerate(levels):
        for nm in names:
            M = getattr(lev, nm, None)
            if not isinstance(M, (lt.DIA, lt.HYB)):
                continue
            for dtype in (torch.float32, torch.float64):
                Md = M.to(dtype=dtype)
                x = torch.from_numpy(rng.uniform(-1, 1, M.shape[1])).to(device=dev, dtype=dtype)
                if isinstance(Md, lt.DIA):
                    kname, y, ref = "dia_spmv", dia_spmv(Md, x), dia_spmv_plain(
                        Md.data, Md.offsets, x)
                else:
                    kname, y, ref = "hyb_spmv", hyb_spmv(Md, x), hyb_spmv_plain(Md, x)
                torch.cuda.synchronize()
                err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{name} L{i} {nm}: non-finite output")
                check(err <= tol[dtype], f"{name} L{i} {nm} ({kname}, {dtype}): max rel err "
                      f"{err:.3e} > {tol[dtype]:.0e}")
                worst[kname] = max(worst.get(kname, 0.0), abs_err)
                count += 1
    print(f"{name}: {count} level products (fp32 and fp64) against their plain versions: "
          f"max abs err {worst}")
    return worst, count


def phase_saamg_main(lt, np, torch, dev, counters, card):
    """Phase 19: bench.py's tts1e8_gmres_saamg on the card."""
    A = lt.sparse.anisotropic_poisson_2d(1024, epsilon=0.01)
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000, restart=30)
    for fn in counters:
        fn.launches = 0
    (_, A64, A32, _, M32), x, info, setup_s, runs = timed_ir(lt, torch, dev, A, "gmres",
                                                            "saamg", opts)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    h = M32.state
    # the counts cover the two solves of timed_ir
    per_it = {k: round(v / (2 * max(info.nits, 1)), 1) for k, v in launches.items() if v}
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    prof = profiled(torch, lambda: lt.solve_ir(A, b, method="gmres", pc="saamg", options=opts),
                    info.nits)
    print(f"saamg main aniso 1024^2 eps 0.01 n={A.shape[0]} nnz={A.nnz} solve_ir "
          f"gmres(30)+saamg [{card}]: inner its {info.nits} (limit 24), true relres {rr:.3e}, "
          f"setup {setup_s:.3f} s (saamg: {', '.join(f'{k} {v:.3f} s' for k, v in h.setup_s.items())}), "
          f"solve first {runs[0]:.3f} s, warm {runs[1]:.3f} s; launches {launches}, per inner "
          f"iteration {per_it}; {prof}")
    print(f"saamg main hierarchy ({len(h.levels)} levels + coarse {h.coarse_inv.shape[0]}): "
          f"{level_table(h.levels)}")
    check(info.nits <= 24, f"saamg main: {info.nits} inner iterations > 24")
    check(rr <= 1e-8, f"saamg main: true relres {rr:.3e} > 1e-8")
    check_only(launches, {"dia_spmv"}, "saamg main")
    errs, _ = check_level_kernels(lt, np, torch, dev, h.levels, "saamg main")
    return launches, errs, info.nits


def phase_amg_classical(lt, np, torch, dev, counters, card):
    """Phase 20: gmres_amg_aniso as it runs off the TPU (Solver, fp64,
    GMRES(30) + amg), at 512²."""
    A = lt.sparse.anisotropic_poisson_2d(512)
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=5000, restart=30)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    for fn in counters:
        fn.launches = 0
    s = lt.Solver(method="gmres", pc="amg", options=opts, device=dev)
    t0 = time.perf_counter()
    s.assemble(A, b)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = s.solve(x0=torch.zeros_like(b))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    h = s.M.state
    limit = count_limit(JAX_CPU_NITS[20])
    prof = profiled(torch, lambda: s.solve(x0=torch.zeros_like(b)), s.nits)
    print(f"amg classical aniso 512^2 eps 1e-3 Solver gmres(30)+amg fp64 [{card}]: nits "
          f"{s.nits} (JAX CPU {JAX_CPU_NITS[20]}, limit {limit}), true relres {rr:.3e}, setup "
          f"{setup_s:.3f} s, solve {walls[0]:.3f} s, {walls[1]:.3f} s; launches of both solves "
          f"{launches}; {prof}")
    print(f"amg classical hierarchy ({len(h.levels)} levels): "
          f"{level_table(h.levels, names=('A', 'P', 'R'))}")
    check(s.nits <= limit, f"amg classical: {s.nits} iterations > {limit}")
    check(rr <= 1e-8, f"amg classical: true relres {rr:.3e} > 1e-8")
    check(launches["dia_spmv"] > 0, "amg classical: K1 was never launched")
    errs, _ = check_level_kernels(lt, np, torch, dev, h.levels, "amg classical", names=("A",))
    return launches, errs


def phase_rsamg(lt, np, torch, dev, counters, card):
    """Phase 21: solve_ir, CG + rsamg, on the 3-D Laplacian 64³."""
    A = lt.sparse.laplacian_3d(64)
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    for fn in counters:
        fn.launches = 0
    (_, _, _, _, M32), x, info, setup_s, runs = timed_ir(lt, torch, dev, A, "cg", "rsamg", opts)
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    limit = count_limit(JAX_CPU_NITS[21])
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    prof = profiled(torch, lambda: lt.solve_ir(A, b, method="cg", pc="rsamg", options=opts),
                    info.nits)
    print(f"rsamg 64^3 solve_ir cg+rsamg [{card}]: inner its {info.nits} (JAX CPU "
          f"{JAX_CPU_NITS[21]}, limit {limit}), true relres {rr:.3e}, setup {setup_s:.3f} s, "
          f"solve first {runs[0]:.3f} s, warm {runs[1]:.3f} s, launches {launches}; {prof}; "
          f"hierarchy {level_table(M32.state.levels, names=('A',))}")
    check(info.nits <= limit, f"rsamg: {info.nits} inner iterations > {limit}")
    check(rr <= 1e-8, f"rsamg: true relres {rr:.3e} > 1e-8")
    check_only(launches, {"dia_spmv"}, "rsamg")
    errs = check_level_kernels(lt, np, torch, dev, M32.state.levels, "rsamg", names=("A",))[0]
    return errs, info.nits


def phase_saamg_block(lt, np, torch, dev, counters, card):
    """Phase 22: solve_ir_multi, block GMRES + saamg, 512², k = 8."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmm_plain, dia_spmv
    A = lt.sparse.anisotropic_poisson_2d(512, epsilon=0.01)
    B = serving_block(np, torch, dev, A.shape[0])
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000, restart=30)
    for fn in counters:
        fn.launches = 0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = lt.solve_ir_multi(A, B, method="blockgmres", pc="saamg", options=opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            launches = {fn.__name__: fn.launches for fn in counters}
    rr = block_relres(A, X, B, np)
    limit = count_limit(JAX_CPU_NITS[22])
    prof = profiled(torch, lambda: lt.solve_ir_multi(A, B, method="blockgmres", pc="saamg",
                                                     options=opts), info.nits)
    print(f"saamg block aniso 512^2 eps 0.01 solve_ir_multi blockgmres+saamg k=8 [{card}]: "
          f"inner its {info.nits} (JAX CPU {JAX_CPU_NITS[22]}, limit {limit}), true relres max "
          f"{rr.max():.3e}, first call (setup included) {walls[0]:.3f} s, warm {walls[1]:.3f} s, "
          f"launches of the first call {launches}; {prof}")
    check((rr <= 1e-8).all(), f"saamg block: true relres {rr} > 1e-8")
    check(info.nits.max() <= limit, f"saamg block: {info.nits.max()} inner iterations > {limit}")
    check(launches["dia_spmm"] > 0, "saamg block: K1k was never launched")
    for kname, count in launches.items():
        check(kname in ("dia_spmm", "dia_spmv") or count == 0,
              f"saamg block: kernel {kname} launched {count} times")
    _, _, _, _, M32 = lt.prepare_ir(A, method="blockgmres", pc="saamg", device=dev)
    worst, count = 0.0, 0
    for i, lev in enumerate(M32.state.levels):
        for nm in ("A", "B", "C"):
            D = getattr(lev, nm)
            if not isinstance(D, lt.DIA):
                continue
            X32 = torch.from_numpy(np.random.default_rng(i).uniform(
                -1, 1, (D.shape[1], 8))).to(device=dev, dtype=torch.float32)
            cols = columns(X32)
            err, abs_err, err1 = check_krhs(
                torch, f"saamg block L{i} {nm}: dia_spmm", lambda: dia_spmm(D, X32),
                lambda: dia_spmm_plain(D.data, D.offsets, X32),
                lambda: [dia_spmv(D, c) for c in cols], 1e-5)
            worst = max(worst, abs_err)
            count += 1
    print(f"saamg block: K1k on {count} level operators, k=8 fp32, against its plain version "
          f"and 8 single launches: max abs err {worst:.3e}")
    return launches, worst


# ---------------------------------------------------------------------------
# The general Krylov methods (phases 23-25)
# ---------------------------------------------------------------------------

KRYLOV = ["cgs", "cr", "crs", "bicrstab", "bicgsafe", "bicrsafe", "gpbicg", "gpbicr",
          "qmrcgstab", "tfqmr", "orthomin", "bicgstabl", "idrs", "lgmres", "rlgmres", "minres",
          "fgmres"]
# JAX's total inner iteration counts on the CPU for phases 23 and 24, solve_ir with
# ILU(0) by 6 Neumann sweeps, and whether it converged
# (scripts/jax_krylov_reference.py; a run that stalls ends at max_outer rounds)
JAX_CPU_KRYLOV = {
    23: {
        "cgs": (159, True), "cr": (182, True), "crs": (125, True), "bicrstab": (129, True),
        "bicgsafe": (109, True), "bicrsafe": (130, True), "gpbicg": (103, True),
        "gpbicr": (122, True), "qmrcgstab": (118, True), "tfqmr": (183, True),
        "orthomin": (181, True), "bicgstabl": (126, True), "idrs": (277, True),
        "lgmres": (202, True), "rlgmres": (202, True), "minres": (249, True),
        "fgmres": (199, True),
    },
    24: {
        "cgs": (1704, True), "cr": (1400, True), "crs": (2430, False),
        "bicrstab": (3911, False), "bicgsafe": (1065, True), "bicrsafe": (1727, False),
        "gpbicg": (1224, True), "gpbicr": (929, True), "qmrcgstab": (2000, True),
        "tfqmr": (4020, False), "orthomin": (1200, True), "bicgstabl": (1167, True),
        "idrs": (4020, False), "lgmres": (1500, True), "rlgmres": (1500, True),
        "fgmres": (1500, True),
    },
}


# The cells whose count moves with rounding alone: under three changes of b
# by one fp32 ulp (scripts/jax_krylov_reference.py --ulp32) JAX's own CPU
# counts spread as widely as the card's, and stall in some runs (PERF.md §6,
# ROADMAP C properties 9-10).  Each is held to converge where JAX's run
# converges, within 1.5 times JAX's count, and is not held to JAX's stall.
ROUNDING_SENSITIVE = {(23, "idrs"), (24, "cgs"), (24, "bicrstab"), (24, "gpbicr"),
                      (24, "qmrcgstab")}


class InnerRounds:
    """Counts the inner solves (the refinement rounds) of the solve_ir and
    dist_solve_ir calls made inside it, by wrapping the solver that
    ``_inner_plan`` takes from ``refine.solver_for`` at call time (the one
    card's launcher and the mesh's alike)."""

    def __enter__(self):
        from lssp_tpu_torch.solvers import refine
        self.refine, self.solver_for, self.count = refine, refine.solver_for, 0

        def solver_for(*args, **kwargs):
            fn = self.solver_for(*args, **kwargs)

            def counted(*a, **k):
                self.count += 1
                return fn(*a, **k)
            return counted
        refine.solver_for = solver_for
        return self

    def __exit__(self, *exc):
        self.refine.solver_for = self.solver_for


def phase_krylov(lt, np, torch, dev, counters, card, phase, A, name, methods):
    """Phases 23 and 24: solve_ir + ILU(0) (K2, 6 sweeps), rtol 1e-8, for
    each method, every kernel launch counter reset just before each solve:
    only K1 and K2 may launch; a solve that reports convergence has a true
    relres ≤ 1e-8; where JAX's run converges the card's does too, within
    JAX's CPU count + 15 % (``ROUNDING_SENSITIVE``: 1.5 times), and where
    JAX's run stalls the card's stalls too.  Then K1 and K2 against their
    plain versions on the phase's own fp32 matrix and plan, and a profiled
    refinement round of the three slowest methods (distinct inner solvers)."""
    t_phase = time.perf_counter()
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    t0 = time.perf_counter()
    _, _, A32, _, M32 = lt.prepare_ir(A, method=methods[0], pc="ilu0", device=dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    print(f"{name}: n={A.shape[0]} nnz={A.nnz}, setup (prepare_ir) {setup_s:.3f} s")
    walls = {}
    for method in methods:
        ref, ref_conv = JAX_CPU_KRYLOV[phase][method]
        for fn in counters:
            fn.launches = 0
        with InnerRounds() as rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = lt.solve_ir(A, b, method=method, pc="ilu0", options=opts)
            torch.cuda.synchronize()
            walls[method] = (time.perf_counter() - t0, info.nits)
        launches = {fn.__name__: fn.launches for fn in counters}
        rr = true_relres(A, x, np)
        its = max(info.nits, 1)
        sensitive = (phase, method) in ROUNDING_SENSITIVE
        limit = int(1.5 * ref) if sensitive else count_limit(ref)
        print(f"{name} solve_ir {method}+ilu0 [{card}]: inner its {info.nits} (JAX CPU {ref}"
              f"{'' if ref_conv else ', not converged'}, limit {limit}"
              f"{', rounding-sensitive' if sensitive else ''}), outer rounds {rounds.count}, "
              f"warm {walls[method][0]:.3f} s, K1 {launches['dia_spmv'] / its:.2f} and K2 "
              f"{launches['fused_neumann_apply'] / its:.2f} launches an inner iteration, true "
              f"relres {rr:.3e}, converged {info.converged}")
        if info.converged:
            check(rr <= 1e-8 and bool(torch.isfinite(x).all()),
                  f"{name} {method}: reports convergence at a true relres of {rr:.3e}")
        if ref_conv:
            check(info.converged, f"{name} {method}: stalls where JAX's run converges")
            check(info.nits <= limit, f"{name} {method}: {info.nits} inner its > {limit}")
        elif not sensitive:
            check(not info.converged, f"{name} {method}: converged where JAX's run stalls")
        check_only(launches, {"dia_spmv", "fused_neumann_apply"}, f"{name} {method}")
    errs, _ = check_path_kernels(lt, np, torch, dev, A32, M32, name)
    # the three slowest methods with distinct inner solvers (lgmres runs as
    # rlgmres inside solve_ir, fgmres as rgmres)
    inner = {m: lt.solvers.refine._inner_plan(m, opts.resolved(), 1e-3)[0].__name__
             for m in walls}
    slowest = []
    for method in sorted(walls, key=lambda m: -walls[m][0]):
        if len(slowest) < 3 and inner[method] not in {inner[m] for m in slowest}:
            slowest.append(method)
    for method in slowest:
        # one refinement round, a window of the solve's steady state (a whole
        # solve of thousands of iterations is too many events to trace)
        out = {}

        def one_round():
            out["info"] = lt.solve_ir(A, b, method=method, pc="ilu0", options=opts,
                                      max_outer=1)[1]
        wall, busy, launches, top, every = profile_solve(torch, one_round)
        its = max(out["info"].nits, 1)
        k2 = every.get("neumann_wavefront_kernel", 0.0) / max(sum(every.values()), 1e-12)
        print(f"{name} solve_ir {method}+ilu0 [{card}]: profiled first refinement round: "
              f"{out['info'].nits} inner its in {wall:.3f} s ({wall / its * 1e3:.3f} ms an inner "
              f"iteration), device busy {busy:.1%}, {launches / its:.1f} device launches an "
              f"inner iteration, K2 {k2:.1%} of the device time, device ms by kernel {top}")
    print(f"{name}: phase time {time.perf_counter() - t_phase:.1f} s")
    return errs


def phase_krylov_per_column(lt, np, torch, dev, counters, N=48):
    """Phase 25: solve_multi + ILU(0), fp64, N³, k = 4, for each method:
    every column's count its own single solve's ±1, and only K1k and K2k
    launch for the block; then K1k and K2k on the solve's own fp64 matrix
    and plan."""
    t_phase = time.perf_counter()
    A = lt.sparse.laplacian_3d(N)
    B = serving_block(np, torch, dev, A.shape[0], k=4)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    for method in KRYLOV:
        for fn in counters:
            fn.launches = 0
        X, info = lt.solve_multi(A, B, method=method, pc="ilu0", options=opts)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        singles = [lt.solve(A, B[:, c], method=method, pc="ilu0", options=opts)
                   for c in range(4)]
        its = [i.nits for _, i in singles]
        dx = max((torch.linalg.vector_norm(X[:, c] - x) / torch.linalg.vector_norm(x)).item()
                 for c, (x, _) in enumerate(singles))
        rr = block_relres(A, X, B, np)
        print(f"per-column {N}^3 solve_multi {method}+ilu0 fp64 k=4: nits {info.nits}, single "
              f"solves {its}, x rel diff {dx:.3e}, true relres max {rr.max():.3e}")
        check(bool(np.all(info.converged)), f"per-column {method}: not every column converged")
        check((np.abs(info.nits - np.array(its)) <= 1).all(),
              f"per-column {method}: counts {info.nits} against single solves {its}")
        # each lane's dot is its column's torch.dot (solvers/base.dot); IDR(s)'s
        # Pᵀv is one product for the block
        check(dx == 0.0 or method == "idrs",
              f"per-column {method}: a column differs from its single solve by {dx:.3e}")
        check_only(launches, {"dia_spmm", "neumann_block_apply"}, f"per-column {method}")
    S = lt.Solver(method="cg", pc="ilu0", device=dev).assemble(A)
    errs = check_block_kernels(lt, torch, S.A_dev, S.M, B, 1e-12, "per-column krylov")
    print(f"per-column krylov {N}^3: phase time {time.perf_counter() - t_phase:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# Block matrices and the distributed AMG (phases 26-27)
# ---------------------------------------------------------------------------

# JAX's inner iteration counts on the CPU for phases 26-27 at their full sizes
# (scripts/jax_amg_reference.py 26 26acc 26multi 27 27rs 27amg 27multi; 26acc:
# (solve_ir with 6 sweeps, the fp64 Solver exact); 27: (8 shards, one device);
# the multi cells: the largest column's)
JAX_CPU_BLOCK = {"26": 3672, "26acc": (112, 48), "26multi": 4000, "27": (21, 21),
                 "27rs": 11, "27amg": 11, "27multi": 15}
# bicgstabl_biluk_elasticity's recorded count (benchmarks/results_r05.json: solve_ir,
# 6 Neumann sweeps), and JAX's CPU counts of that route under six changes of b by
# one fp32 ulp (scripts/jax_amg_reference.py 26acc): the fp32 inner solves turn
# such a change into 104-121 iterations, so the card's count is held to JAX's
# largest + 15 %, not to the recorded count
ACCEPTANCE_BILUK = 111
JAX_CPU_ACC_ULP32 = (104, 108, 121, 108, 107, 113)
# JAX's single-device against distributed tolerance (tests/test_dist.py:117)
DIST_VS_SINGLE = 3


class Timers:
    """Host seconds spent in the named functions of a module while inside,
    by wrapping them (the setup split of a prepare)."""

    def __init__(self, module, *names):
        self.module, self.names, self.seconds = module, names, dict.fromkeys(names, 0.0)

    def __enter__(self):
        self.saved = {nm: getattr(self.module, nm) for nm in self.names}
        for nm, fn in self.saved.items():
            def timed(*args, _fn=fn, _nm=nm, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.seconds[_nm] += time.perf_counter() - t0
            setattr(self.module, nm, timed)
        return self

    def __exit__(self, *exc):
        for nm, fn in self.saved.items():
            setattr(self.module, nm, fn)


def check_k1_on(np, torch, dev, D, name, dtypes=None):
    """K1 against its plain version on one DIA in fp32 and fp64 (1e-5 /
    1e-12), or in ``dtypes``; returns the max abs err."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    x64 = torch.from_numpy(np.random.default_rng(26).uniform(-1, 1, D.shape[1])).to(dev)
    worst = 0.0
    for dtype in dtypes or (torch.float32, torch.float64):
        Dd, x = D.to(dtype=dtype), x64.to(dtype)
        y, ref = dia_spmv(Dd, x), dia_spmv_plain(Dd.data, Dd.offsets, x)
        torch.cuda.synchronize()
        err = rel_err(y, ref)
        check(bool(torch.isfinite(y).all()) and err <= tol[dtype],
              f"{name}: K1 {dtype} max rel err {err:.3e} > {tol[dtype]:.0e}")
        worst = max(worst, (y - ref).abs().max().item())
    names = ", ".join(str(d)[6:] for d in dtypes or (torch.float32, torch.float64))
    print(f"{name}: K1 against its plain version ({names}): max abs err {worst:.3e}")
    return worst


def phase_block(lt, np, torch, dev, counters, card):
    """Phase 26: block matrices.  solve_ir, BiCGSTAB(l) + biluk (2×2 blocks,
    6 sweeps), on the elasticity 512² as a BSR: the prepared format is
    scalar DIA and only K1 launches; the host setup split; K1 on the
    phase's own matrix.  Then the acceptance config
    bicgstabl_biluk_elasticity (both routes), and solve_ir_multi block CG +
    biluk, k = 4, on the 512² BSR, where only K1k launches."""
    from lssp_tpu_torch.pc import biluk
    from lssp_tpu_torch.solvers import facade
    t_phase = time.perf_counter()
    A = lt.sparse.csr_to_bsr(lt.sparse.elasticity_2d(512), 2)
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    pco = lt.PCOptions(block_size=2)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    for fn in counters:
        fn.launches = 0
    with Timers(facade, "bsr_to_csr", "_bsr_device_format") as tf, \
            Timers(biluk, "_to_bsr", "biluk_factor_bsr", "pack_bilu_pc") as tb:
        t0 = time.perf_counter()
        _, A64, A32, _, M32 = lt.prepare_ir(A, method="bicgstabl", pc="biluk", pc_options=pco,
                                            device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = lt.solve_ir(A, b, method="bicgstabl", pc="biluk", options=opts, pc_options=pco)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    ref = JAX_CPU_BLOCK["26"]
    limit = count_limit(ref)
    # one refinement round profiled: a window of the solve's steady state
    out = {}

    def one_round():
        out["info"] = lt.solve_ir(A, b, method="bicgstabl", pc="biluk", options=opts,
                                  pc_options=pco, max_outer=1)[1]
    wall, busy, nlaunch, top, every = profile_solve(torch, one_round)
    its = max(out["info"].nits, 1)
    prof = (f"profiled first refinement round: {out['info'].nits} inner its in {wall:.3f} s, "
            f"device busy {busy:.1%}, {nlaunch / its:.1f} device launches an inner iteration, "
            f"K1 {every.get('dia_spmv_kernel', 0.0) / max(sum(every.values()), 1e-12):.1%} of "
            f"the device time, device ms by kernel {top}")
    split = {"BSR->CSR": tf.seconds["bsr_to_csr"], "CSR->DIA+upload": tf.seconds[
        "_bsr_device_format"], "CSR->BSR": tb.seconds["_to_bsr"], "block factorization":
        tb.seconds["biluk_factor_bsr"], "BDIA packing+upload": tb.seconds["pack_bilu_pc"]}
    print(f"block elasticity 512^2 BSR bs=2 n={A.shape[0]} nnzb={A.nnzb} solve_ir "
          f"bicgstabl+biluk [{card}]: format {type(A32).__name__}"
          f"({len(getattr(A32, 'offsets', ()))} diagonals), PC {M32.name}, inner its "
          f"{info.nits} (JAX CPU {ref}, limit {limit}), true relres {rr:.3e}, setup "
          f"{setup_s:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in split.items())}), warm "
          f"solve {warm:.3f} s; launches {launches}, K1 "
          f"{launches['dia_spmv'] / max(info.nits, 1):.2f} an inner iteration; {prof}")
    check(isinstance(A32, lt.DIA) and isinstance(A64, lt.DIA),
          f"block: the prepared format is {type(A32).__name__}, not scalar DIA")
    check(info.nits <= limit, f"block: {info.nits} inner iterations > {limit}")
    check(rr <= 1e-8, f"block: true relres {rr:.3e} > 1e-8")
    check_only(launches, {"dia_spmv"}, "block")
    err = check_k1_on(np, torch, dev, A64, "block elasticity 512^2")
    # the acceptance config, by the TPU's route and the CPU's
    Aacc = lt.sparse.elasticity_2d(48)
    bacc = torch.ones(Aacc.shape[0], dtype=torch.float64, device=dev)
    ir_ref, exact_ref = JAX_CPU_BLOCK["26acc"]
    xa, ia = lt.solve_ir(Aacc, bacc, method="bicgstabl", pc="biluk", options=opts,
                         pc_options=pco)
    s = lt.Solver(method="bicgstabl", pc="biluk", options=opts,
                  pc_options=lt.PCOptions(block_size=2, ilu_sweeps=0), device=dev)
    xs = s.assemble(Aacc, bacc).solve()
    rra, rrs = true_relres(Aacc, xa, np), true_relres(Aacc, xs, np)
    print(f"acceptance bicgstabl_biluk_elasticity elasticity_2d(48) [{card}]: solve_ir (6 "
          f"sweeps) inner its {ia.nits} (recorded {ACCEPTANCE_BILUK}, JAX CPU {ir_ref}, under "
          f"fp32-ulp changes of b {min(JAX_CPU_ACC_ULP32)}-{max(JAX_CPU_ACC_ULP32)}; limit "
          f"{count_limit(max(ir_ref, *JAX_CPU_ACC_ULP32))}), true "
          f"relres {rra:.3e}; Solver fp64 exact block schedules nits {s.nits} (JAX CPU "
          f"{exact_ref}), true relres {rrs:.3e}")
    acc_limit = count_limit(max(ir_ref, *JAX_CPU_ACC_ULP32))
    check(ia.nits <= acc_limit, f"acceptance biluk: {ia.nits} inner its > {acc_limit}")
    check(abs(s.nits - exact_ref) <= 1, f"acceptance biluk exact: {s.nits} its, JAX {exact_ref}")
    check(rra <= 1e-8 and rrs <= 1e-8, f"acceptance biluk: true relres {rra:.3e}, {rrs:.3e}")
    # the block path on the same 512^2 BSR
    B = serving_block(np, torch, dev, A.shape[0], k=4)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, mi = lt.solve_ir_multi(A, B, method="blockcg", pc="biluk", options=opts, pc_options=pco)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mlaunches = {fn.__name__: fn.launches for fn in counters}
    rrm = block_relres(A, X, B, np)
    mlimit = count_limit(JAX_CPU_BLOCK["26multi"])
    print(f"block multi elasticity 512^2 BSR solve_ir_multi blockcg+biluk k=4 [{card}]: inner "
          f"its {mi.nits} (JAX CPU {JAX_CPU_BLOCK['26multi']}, limit {mlimit}), true relres max "
          f"{rrm.max():.3e}, {wall:.3f} s (setup memoized), launches {mlaunches}")
    check((rrm <= 1e-8).all(), f"block multi: true relres {rrm} > 1e-8")
    check(int(mi.nits.max()) <= mlimit, f"block multi: {mi.nits.max()} inner its > {mlimit}")
    check_only(mlaunches, {"dia_spmm"}, "block multi")
    print(f"block: phase time {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def check_dist_levels(np, torch, dev, levels, name):
    """K4 against its plain version (product and sweep epilogue, fp32, 1e-5)
    on every DistDIA operator of a distributed hierarchy's levels (a
    DistHYB's band too).  Returns (max abs err, operators checked)."""
    from lssp_tpu_torch.parallel import DistDIA, DistHYB, halo_exchange
    rng = np.random.default_rng(27)
    worst, count = 0.0, 0
    for i, lev in enumerate(levels):
        for nm in ("A", "B", "C"):
            M = getattr(lev, nm)
            M = M.band if isinstance(M, DistHYB) else M
            if not isinstance(M, DistDIA):
                continue
            M = M.to(dtype=torch.float32)
            P, R = M.nshards, M.rows_per_shard
            v = torch.from_numpy(rng.uniform(-1, 1, (P, R))).to(device=dev, dtype=torch.float32)
            _, abs_err = check_k4(torch, M, halo_exchange(v, M.lo, M.hi), v, 1e-5,
                                  f"{name} L{i} {nm}")
            worst = max(worst, abs_err)
            count += 1
    print(f"{name}: K4 on {count} level operators' shards against its plain version: max abs "
          f"err {worst:.3e}")
    return worst, count


def dist_level_table(h):
    """Each distributed level's rows and each operator's format."""
    return "; ".join(f"L{i} n={lev.dinv.numel()} " + " ".join(
        f"{nm} {type(getattr(lev, nm)).__name__}" for nm in ("A", "B", "C")
        if getattr(lev, nm) is not None) for i, lev in enumerate(h.levels))


def phase_dist_amg(lt, np, torch, dev, counters, card, single_saamg, single_rsamg):
    """Phase 27: the distributed AMG on 8 shards of the card.
    dist_solve_ir GMRES(30) + saamg on phase 19's anisotropic 1024²: ≤ JAX's
    CPU count + 15 % and within 3 of phase 19's single-device count; CG +
    rsamg on 64³ ≤ JAX's distributed CPU count + 15 % (JAX's own 8-shard
    hierarchy is not its single-device one: 11 against 13 iterations, so
    phase 21's count is printed beside it, not held); classical amg fp64 at
    512²;
    dist_solve_ir_multi block CG + saamg 512², k = 8.  The saamg and rsamg
    cells launch only K4 (K4k); K4 checked on every DistDIA level."""
    t_phase = time.perf_counter()
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    out = {}

    def run(A, method, pc, o, fn=lt.dist_solve_ir, B=None, profile=False):
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev) if B is None else B
        for f in counters:
            f.launches = 0
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = fn(A, b, method=method, pc=pc, mesh=mesh, options=o)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {f.__name__: f.launches for f in counters}
        prof = profiled(torch, lambda: fn(A, b, method=method, pc=pc, mesh=mesh, options=o),
                        info.nits, "dia_spmv_ext_kernel") if profile else ""
        (prep,) = [e for k, e in A._dist_cache.items() if k[2] == pc]
        return x, info, walls, launches, prep, prof

    A = lt.sparse.anisotropic_poisson_2d(1024, epsilon=0.01)
    x, info, walls, launches, prep, prof = run(A, "gmres", "saamg",
                                               dataclasses.replace(opts, restart=30),
                                               profile=True)
    rr = true_relres(A, x, np)
    ref, ref1 = JAX_CPU_BLOCK["27"]
    limit = count_limit(ref)
    h = prep["pc_state"]
    print(f"dist saamg aniso 1024^2 eps 0.01 over 8 shards dist_solve_ir gmres(30)+saamg "
          f"[{card}]: inner its {info.nits} (JAX CPU 8 shards {ref}, one device {ref1}; limit "
          f"{limit}; phase 19 on the card {single_saamg}), true relres {rr:.3e}, first call "
          f"(setup included) {walls[0]:.3f} s, warm {walls[1]:.3f} s, launches of both "
          f"{launches}; {prof}; hierarchy {dist_level_table(h)} + coarse "
          f"{h.coarse_inv.shape[0]}")
    check(info.nits <= limit, f"dist saamg: {info.nits} inner its > {limit}")
    check(abs(info.nits - single_saamg) <= DIST_VS_SINGLE,
          f"dist saamg: {info.nits} inner its, single device {single_saamg}")
    check(rr <= 1e-8, f"dist saamg: true relres {rr:.3e} > 1e-8")
    check_only(launches, {"dia_spmv_ext"}, "dist saamg")
    out["saamg"] = check_dist_levels(np, torch, dev, h.levels, "dist saamg")[0]
    out["saamg_launches"] = launches
    # CG + rsamg on 64^3
    A = lt.sparse.laplacian_3d(64)
    x, info, walls, launches, prep, prof = run(A, "cg", "rsamg", opts, profile=True)
    rr = true_relres(A, x, np)
    h = prep["pc_state"]
    limit = count_limit(JAX_CPU_BLOCK["27rs"])
    print(f"dist rsamg 64^3 over 8 shards dist_solve_ir cg+rsamg [{card}]: inner its "
          f"{info.nits} (JAX CPU 8 shards {JAX_CPU_BLOCK['27rs']}, one device "
          f"{JAX_CPU_NITS[21]}; limit {limit}; phase 21 on the card {single_rsamg}), true relres "
          f"{rr:.3e}, first call {walls[0]:.3f} s, warm {walls[1]:.3f} s, launches {launches}; "
          f"{prof}; hierarchy {dist_level_table(h)}")
    check(info.nits <= limit, f"dist rsamg: {info.nits} inner its > {limit}")
    check(rr <= 1e-8, f"dist rsamg: true relres {rr:.3e} > 1e-8")
    check_only(launches, {"dia_spmv_ext"}, "dist rsamg")
    out["rsamg"] = check_dist_levels(np, torch, dev, h.levels, "dist rsamg")[0]
    # classical amg, fp64, on phase 20's 512^2
    A = lt.sparse.anisotropic_poisson_2d(512)
    o = dataclasses.replace(opts, restart=30, maxit=5000)
    x, info, walls, launches, prep, _ = run(A, "gmres", "amg", o, fn=lt.dist_solve)
    rr = true_relres(A, x, np)
    limit = count_limit(JAX_CPU_BLOCK["27amg"])
    print(f"dist amg aniso 512^2 eps 1e-3 over 8 shards dist_solve gmres(30)+amg fp64 "
          f"[{card}]: its {info.nits} (JAX CPU 8 shards {JAX_CPU_BLOCK['27amg']}, limit "
          f"{limit}), true relres {rr:.3e}, first call {walls[0]:.3f} s, warm {walls[1]:.3f} s, "
          f"launches {launches} (the Krylov operator; the levels gather)")
    check(info.nits <= limit, f"dist amg: {info.nits} its > {limit}")
    check(rr <= 1e-8, f"dist amg: true relres {rr:.3e} > 1e-8")
    # block CG + saamg, 512^2, k = 8
    A = lt.sparse.anisotropic_poisson_2d(512, epsilon=0.01)
    B = serving_block(np, torch, dev, A.shape[0])
    X, info, walls, launches, prep, _ = run(A, "blockcg", "saamg", opts,
                                            fn=lt.dist_solve_ir_multi, B=B)
    rrm = block_relres(A, X, B, np)
    limit = count_limit(JAX_CPU_BLOCK["27multi"])
    print(f"dist saamg block aniso 512^2 eps 0.01 over 8 shards dist_solve_ir_multi "
          f"blockcg+saamg k=8 [{card}]: inner its {info.nits} (JAX CPU 8 shards "
          f"{JAX_CPU_BLOCK['27multi']}, limit {limit}), true relres max {rrm.max():.3e}, first "
          f"call {walls[0]:.3f} s, warm {walls[1]:.3f} s, launches {launches}")
    check((rrm <= 1e-8).all(), f"dist saamg block: true relres {rrm} > 1e-8")
    check(int(info.nits.max()) <= limit, f"dist saamg block: {info.nits.max()} its > {limit}")
    check_only(launches, {"dia_spmm_ext"}, "dist saamg block")
    print(f"dist amg: phase time {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The transpose path and the relaxation, polynomial and Schwarz PCs
# (phases 28-29)
# ---------------------------------------------------------------------------

# JAX's inner iteration counts on the CPU for phases 28-29 at their full sizes
# (scripts/jax_krylov_reference.py 28 28cd 28tall 28dist 29; solve_ir with 6
# Neumann sweeps, rtol 1e-8; 28tall: solve lsqr fp64 through JAX's ELL of the
# tall system, as its own HYB route fails; 29's ssor / sor / gs cells with the
# factors kept in the matrix's dtype, as JAX's own fp32 route fails)
JAX_CPU_TRANSPOSE = {
    "28": {"bicg": 195, "qmr": 193, "cgnr": 2063, "lsqr": 2399},
    "28cd": {"bicg": 2787, "qmr": 2800},
    "28tall": 694,
    "28dist": {("bicg", "bjilu"): 180, ("qmr", "jacobi"): 519},
    "29": {"cg+ssor": 213, "cg+poly": 92, "cg+chebyshev": 92, "gmres30+sor": 832,
           "gmres30+gs": 832, "gmres30+ras": 576, "gmres30+schwarz": 576,
           "gmres30+bjacobi": 576, "bicg+ssor": 225, "qmr+poly": 101},
}
TRANSPOSE_METHODS = ("bicg", "qmr", "cgnr", "lsqr")
# phase 29: (cell, method, pc, restart, extra PCOptions), as the script runs them
RELAX_CELLS = [("cg+ssor", "cg", "ssor", None, {}), ("cg+poly", "cg", "poly", None, {}),
               ("cg+chebyshev", "cg", "chebyshev", None, {}),
               ("gmres30+sor", "gmres", "sor", 30, {"omega": 1.3}),
               ("gmres30+gs", "gmres", "gs", 30, {}), ("gmres30+ras", "gmres", "ras", 30, {}),
               ("gmres30+schwarz", "gmres", "schwarz", 30, {}),
               ("gmres30+bjacobi", "gmres", "bjacobi", 30, {}),
               ("bicg+ssor", "bicg", "ssor", None, {}), ("qmr+poly", "qmr", "poly", None, {})]


class TransposedLaunches:
    """Counts the K2 / K2k launches made on the given transposed plans inside
    it, by watching the one launch function both wrappers call
    (``ops/neumann._apply``), which still adds to their own counters."""

    def __init__(self, plans):
        self.ids, self.count = {id(p) for p in plans}, 0

    def __enter__(self):
        from lssp_tpu_torch.ops import neumann
        self.neumann, self.apply = neumann, neumann._apply

        def watched(plan, *args):
            self.count += id(plan) in self.ids
            return self.apply(plan, *args)
        neumann._apply = watched
        return self

    def __exit__(self, *exc):
        self.neumann._apply = self.apply


def transposed_plans(M):
    """The transposed K2 plan of a PC built with its M⁻ᵀ apply (a
    ``(forward, transposed)`` pair of plans), or an empty list."""
    from lssp_tpu_torch.ops.neumann import FusedNeumann
    st = getattr(M, "state", None)
    return [st[1]] if isinstance(st, tuple) and len(st) == 2 \
        and isinstance(st[1], FusedNeumann) else []


def held(phase, cell, ref, nits, converged, rr, name):
    """A cell's count against JAX's CPU count + 15 % (``ROUNDING_SENSITIVE``:
    1.5 times), its convergence, and a true relres ≤ 1e-8."""
    sensitive = (phase, cell) in ROUNDING_SENSITIVE
    limit = int(1.5 * ref) if sensitive else count_limit(ref)
    check(converged, f"{name}: not converged")
    check(rr <= 1e-8, f"{name}: true relres {rr:.3e} > 1e-8")
    check(nits <= limit, f"{name}: {nits} inner its > {limit}")
    return f"JAX CPU {ref}, limit {limit}{', rounding-sensitive' if sensitive else ''}"


def ir_transpose_cells(lt, np, torch, dev, counters, card, phase, A, name, methods):
    """solve_ir + ILU(0) (6 sweeps: K2 forward, K2 on the transposed plan for
    M⁻ᵀ), rtol 1e-8, for each transpose method: the count, outer rounds, the
    warm wall, K1, K2 and transposed-K2 launches an inner iteration; only K1
    and K2 launch.  Returns (the first method's prepared tuple, walls)."""
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    prep, walls = None, {}
    for method in methods:
        t0 = time.perf_counter()
        p = lt.prepare_ir(A, method=method, pc="ilu0", device=dev)
        setup_s = time.perf_counter() - t0
        prep = prep or p
        check(len(transposed_plans(p[4])) == 1, f"{name} {method}: no transposed K2 plan")
        for fn in counters:
            fn.launches = 0
        with InnerRounds() as rounds, TransposedLaunches(transposed_plans(p[4])) as tl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = lt.solve_ir(A, b, method=method, pc="ilu0", options=opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        rr = true_relres(A, x, np)
        its = max(info.nits, 1)
        walls[method] = wall
        ref = JAX_CPU_TRANSPOSE[phase][method]
        lim = held(phase, method, ref, info.nits, info.converged, rr, f"{name} {method}")
        print(f"{name} solve_ir {method}+ilu0 [{card}]: inner its {info.nits} ({lim}), outer "
              f"rounds {rounds.count}, setup (prepare_ir) {setup_s:.3f} s, warm {wall:.3f} s, "
              f"K1 {launches['dia_spmv'] / its:.2f} and K2 "
              f"{launches['fused_neumann_apply'] / its:.2f} launches an inner iteration (K2 on "
              f"the transposed plan {tl.count / its:.2f}), true relres {rr:.3e}")
        check(tl.count > 0, f"{name} {method}: K2 never ran on the transposed plan")
        check_only(launches, {"dia_spmv", "fused_neumann_apply"}, f"{name} {method}")
    return prep, walls


def check_transposed_plan(lt, np, torch, dev, plan32, A, name):
    """K2 and K2k against their plain versions on the phase's own
    transposed fp32 plan (1e-5) and on the fp64 transposed ILU(0) plan of
    the same matrix (1e-12); that plan's plain apply against
    ``neumann_ilu_apply_t`` (JAX's transposed sweeps on spmv_t) on the same
    factors (1e-12).  Returns {kernel: max abs err}."""
    from lssp_tpu_torch.ops.neumann import (fused_neumann_apply, neumann_apply_plain,
                                            neumann_block_apply, plan_fused_neumann_t)
    from lssp_tpu_torch.ops.trisolve import make_neumann_tri, neumann_ilu_apply_t
    L, U = lt.pc.iluk_factor(A, level=0)
    plan64 = plan_fused_neumann_t(L, U, 6, device=dev)
    out = {"neumann_sweep": 0.0, "neumann_sweep_block": 0.0}
    rng = np.random.default_rng(28)
    for plan, tol in ((plan32, 1e-5), (plan64, 1e-12)):
        dt = plan.dtype
        v = torch.from_numpy(rng.uniform(-1, 1, plan.n)).to(device=dev, dtype=dt)
        V = torch.from_numpy(rng.uniform(-1, 1, (plan.n, 4))).to(device=dev, dtype=dt)
        for kname, kernel, plain in (
                ("neumann_sweep", lambda: fused_neumann_apply(plan, v),
                 lambda: neumann_apply_plain(plan, v)),
                ("neumann_sweep_block", lambda: neumann_block_apply(plan, V),
                 lambda: neumann_apply_plain(plan, V))):
            y, ref = kernel(), plain()
            torch.cuda.synchronize()
            err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"{name}: {kname} on the transposed {dt} plan: max rel err {err:.3e} > {tol:.0e}")
            print(f"{name}: {kname} against its plain version on the transposed {str(dt)[6:]} "
                  f"plan: max_rel_err {err:.3e} max_abs_err {abs_err:.3e}")
            out[kname] = max(out[kname], abs_err)
    v = torch.from_numpy(rng.uniform(-1, 1, plan64.n)).to(dev)
    ref = neumann_ilu_apply_t(make_neumann_tri(L, U, 6, device=dev), v)
    err = rel_err(neumann_apply_plain(plan64, v), ref)
    check(err <= 1e-12, f"{name}: the transposed plan's plain apply against "
          f"neumann_ilu_apply_t: max rel err {err:.3e}")
    print(f"{name}: the transposed fp64 plan's plain apply against neumann_ilu_apply_t "
          f"(transposed sweeps on spmv_t): max_rel_err {err:.3e}")
    return out


def tall_system(lt, np, N):
    """[L; 0.1·I] with L = laplacian_2d(N): a Tikhonov-regularised Poisson
    least-squares system."""
    import scipy.sparse as sp
    L = lt.sparse.laplacian_2d(N).to_scipy()
    S = sp.vstack([L, 0.1 * sp.eye(L.shape[0], format="csr")]).tocsr()
    S.sort_indices()
    return lt.CSR.from_scipy(S)


def phase_tall(lt, np, torch, dev, counters, card):
    """The tall lsqr cell of phase 28: solve(..., method="lsqr"), fp64, no
    PC, on [L; 0.1·I], L = laplacian_2d(1024), b = A·1: its format, the
    count (≤ JAX's through ELL + 15 %), ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ ≤ 1e-6; the
    forward product (K3 on the HYB) against scipy and against its plain
    version on the phase's own matrix.  Returns {kernel: max abs err}."""
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv, hyb_spmv_plain
    from lssp_tpu_torch.ops.spmv import spmv_t
    t_phase = t0 = time.perf_counter()
    A = tall_system(lt, np, 1024)
    S = A.to_scipy()
    bh = S @ np.ones(S.shape[1])
    b = torch.from_numpy(bh).to(dev)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=20000)
    A_dev = lt.solvers.facade._prepare_matrix(A, device=dev)[1]
    setup_s = time.perf_counter() - t0
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = lt.solve(A, b, method="lsqr", options=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    r = bh - S @ x.cpu().numpy()
    normal = float(np.linalg.norm(S.T @ r) / np.linalg.norm(S.T @ bh))
    ref = JAX_CPU_TRANSPOSE["28tall"]
    limit = count_limit(ref)
    print(f"tall lsqr [laplacian_2d(1024); 0.1 I] {S.shape[0]}x{S.shape[1]} [{card}]: format "
          f"{type(A_dev).__name__} (remainder {getattr(A_dev, 'nnz_rem', 0)}), its {info.nits} "
          f"(JAX CPU through ELL {ref}, limit {limit}), converged {info.converged}, "
          f"||A^T(b-Ax)||/||A^T b|| {normal:.3e}, relres {np.linalg.norm(r) / np.linalg.norm(bh):.3e}, "
          f"setup {setup_s:.3f} s, solve {wall:.3f} s, K3 {launches['hyb_spmv'] / max(info.nits, 1):.2f} "
          f"launches an iteration")
    check(isinstance(A_dev, lt.HYB), f"tall lsqr: format {type(A_dev).__name__}, not HYB")
    check(info.converged and normal <= 1e-6, f"tall lsqr: normal-equation relres {normal:.3e}")
    check(info.nits <= limit, f"tall lsqr: {info.nits} its > {limit}")
    check_only(launches, {"hyb_spmv"}, "tall lsqr")
    xv = np.random.default_rng(29).uniform(-1, 1, S.shape[1])
    xt = torch.from_numpy(xv).to(dev)
    out = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        H, xd = A_dev.to(dtype=dtype), xt.to(dtype)
        y, plain = hyb_spmv(H, xd), hyb_spmv_plain(H, xd)
        ys = torch.from_numpy(S @ xv).to(device=dev, dtype=dtype)
        torch.cuda.synchronize()
        err, err_s = rel_err(y, plain), rel_err(y, ys)
        check(err <= tol and err_s <= tol, f"tall lsqr: K3 {dtype} max rel err {err:.3e} "
              f"(plain), {err_s:.3e} (scipy)")
        out["hyb_spmv"] = max(out.get("hyb_spmv", 0.0), (y - plain).abs().max().item())
        print(f"tall lsqr: K3 on the tall {str(dtype)[6:]} HYB: max_rel_err {err:.3e} (plain) "
              f"{err_s:.3e} (scipy)")
    yt = spmv_t(A_dev, torch.from_numpy(bh).to(dev)).cpu().numpy()
    err_t = float(np.abs(yt - S.T @ bh).max() / np.abs(S.T @ bh).max())
    check(yt.shape == (S.shape[1],) and err_t <= 1e-12, f"tall lsqr: spmv_t err {err_t:.3e}")
    print(f"tall lsqr: spmv_t on the tall HYB against scipy: {yt.shape[0]} entries, max rel err "
          f"{err_t:.3e}; cell time {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_transpose(lt, np, torch, dev, counters, card):
    """Phase 28: the transpose path.  solve_ir + ILU(0) for bicg, qmr, cgnr
    and lsqr on 128³, and bicg and qmr on the convection-diffusion 1024²;
    the tall lsqr; the per-column forms (solve_multi fp64 48³, k = 4); the
    distributed bicg + bjilu and qmr + jacobi on 8 shards; K2 and K2k on the
    transposed plans.  Returns {kernel: max abs err}."""
    t_phase = time.perf_counter()
    errs = {}

    def worst(more):
        for k, v in more.items():
            errs[k] = max(errs.get(k, 0.0), v)

    A = lt.sparse.laplacian_3d(128)
    prep, walls = ir_transpose_cells(lt, np, torch, dev, counters, card, "28", A,
                                     "transpose 128^3", TRANSPOSE_METHODS)
    worst(check_transposed_plan(lt, np, torch, dev, transposed_plans(prep[4])[0], A,
                                "transpose 128^3"))
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    for method in ("bicg", "cgnr"):
        out = {}

        def one_round():
            out["info"] = lt.solve_ir(A, b, method=method, pc="ilu0", options=opts,
                                      max_outer=1)[1]
        wall, busy, nlaunch, top, every = profile_solve(torch, one_round)
        its = max(out["info"].nits, 1)
        k2 = every.get("neumann_wavefront_kernel", 0.0) / max(sum(every.values()), 1e-12)
        print(f"transpose 128^3 solve_ir {method}+ilu0 [{card}]: profiled first refinement "
              f"round: {out['info'].nits} inner its in {wall:.3f} s ({wall / its * 1e3:.3f} ms an "
              f"inner iteration), device busy {busy:.1%}, {nlaunch / its:.1f} device launches an "
              f"inner iteration, K2 {k2:.1%} of the device time, device ms by kernel {top}")
    cd = lt.sparse.convection_diffusion_2d(1024)
    ir_transpose_cells(lt, np, torch, dev, counters, card, "28cd", cd,
                       "transpose convdiff 1024^2", ("bicg", "qmr"))
    worst(phase_tall(lt, np, torch, dev, counters, card))
    # the per-column forms
    N = 48
    A48 = lt.sparse.laplacian_3d(N)
    B = serving_block(np, torch, dev, A48.shape[0], k=4)
    for method in TRANSPOSE_METHODS:
        M = lt.Solver(method=method, pc="ilu0", device=dev).assemble(A48).M
        for fn in counters:
            fn.launches = 0
        with TransposedLaunches(transposed_plans(M)) as tl:
            X, info = lt.solve_multi(A48, B, method=method, M=M, options=opts)
            torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        singles = [lt.solve(A48, B[:, c], method=method, M=M, options=opts)[1].nits
                   for c in range(4)]
        rr = block_relres(A48, X, B, np)
        print(f"per-column {N}^3 solve_multi {method}+ilu0 fp64 k=4: nits {info.nits}, single "
              f"solves {singles}, true relres max {rr.max():.3e}, K2k launches on the "
              f"transposed plan {tl.count}")
        check(bool(np.all(info.converged)), f"per-column {method}: not every column converged")
        check((np.abs(info.nits - np.array(singles)) <= 1).all(),
              f"per-column {method}: counts {info.nits} against single solves {singles}")
        check(tl.count > 0, f"per-column {method}: K2k never ran on the transposed plan")
        check_only(launches, {"dia_spmm", "neumann_block_apply"}, f"per-column {method}")
    # the distributed transpose methods
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    for (method, pc), ref in JAX_CPU_TRANSPOSE["28dist"].items():
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.dist_solve_ir(A, b, method=method, pc=pc, mesh=mesh, options=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        rr = true_relres(A, x, np)
        lim = held("28dist", (method, pc), ref, info.nits, info.converged, rr,
                   f"dist {method}+{pc}")
        print(f"dist 128^3 x 8 shards dist_solve_ir {method}+{pc} [{card}]: inner its "
              f"{info.nits} ({lim}), first {wall:.3f} s, K4 "
              f"{launches['dia_spmv_ext'] / max(info.nits, 1):.2f} launches an inner iteration, "
              f"true relres {rr:.3e}")
        check_only(launches, {"dia_spmv_ext"}, f"dist {method}+{pc}")
    print(f"transpose: phase time {time.perf_counter() - t_phase:.1f} s")
    return errs


def phase_relax(lt, np, torch, dev, counters, card):
    """Phase 29: solve_ir on 128³ with the relaxation, polynomial and
    Schwarz preconditioners (``RELAX_CELLS``): each count ≤ JAX's CPU count
    + 15 %, true relres ≤ 1e-8, only K1 and K2; each PC's host setup time
    apart from the warm solve; then K2 against its plain version on the
    ssor (forward and transposed), sor and ras plans and K1 on poly's
    matrix.  Returns {kernel: max abs err}."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply, neumann_apply_plain
    t_phase = time.perf_counter()
    A = lt.sparse.laplacian_3d(128)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    Ms = {}
    for cell, method, pc, restart, extra in RELAX_CELLS:
        opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000,
                                **({"restart": restart} if restart else {}))
        pco = lt.PCOptions(**extra)
        t0 = time.perf_counter()
        M = lt.prepare_ir(A, method=method, pc=pc, pc_options=pco, device=dev)[4]
        setup_s = time.perf_counter() - t0
        Ms[cell] = M
        for fn in counters:
            fn.launches = 0
        with InnerRounds() as rounds, TransposedLaunches(transposed_plans(M)) as tl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = lt.solve_ir(A, b, method=method, pc=pc, options=opts, pc_options=pco)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        rr = true_relres(A, x, np)
        its = max(info.nits, 1)
        lim = held("29", cell, JAX_CPU_TRANSPOSE["29"][cell], info.nits, info.converged, rr,
                   f"relax {cell}")
        print(f"relax 128^3 solve_ir {cell} ({M.name}) [{card}]: inner its {info.nits} ({lim}), "
              f"outer rounds {rounds.count}, PC host setup {setup_s:.3f} s, warm {wall:.3f} s, K1 "
              f"{launches['dia_spmv'] / its:.2f} and K2 {launches['fused_neumann_apply'] / its:.2f}"
              f" launches an inner iteration (K2 on the transposed plan {tl.count / its:.2f}), "
              f"true relres {rr:.3e}")
        allowed = {"dia_spmv"} | ({"fused_neumann_apply"} if "poly" not in pc
                                  and "cheb" not in pc else set())
        check_only(launches, allowed, f"relax {cell}")
        if method in ("bicg", "qmr") and pc == "ssor":
            check(tl.count > 0, f"relax {cell}: K2 never ran on the transposed plan")
    errs = {"neumann_sweep": 0.0, "dia_spmv": 0.0}
    v = torch.from_numpy(np.random.default_rng(30).uniform(-1, 1, A.shape[0])).to(
        device=dev, dtype=torch.float32)
    plans = [("ssor", Ms["bicg+ssor"].state[0]), ("ssor transposed", Ms["bicg+ssor"].state[1]),
             ("sor", Ms["gmres30+sor"].state), ("ras", Ms["gmres30+ras"].state)]
    for pname, plan in plans:
        w = v if plan.n == A.shape[0] else torch.from_numpy(
            np.random.default_rng(31).uniform(-1, 1, plan.n)).to(device=dev, dtype=torch.float32)
        y, ref = fused_neumann_apply(plan, w), neumann_apply_plain(plan, w)
        torch.cuda.synchronize()
        err = rel_err(y, ref)
        check(bool(torch.isfinite(y).all()) and err <= 1e-5,
              f"relax: K2 on the {pname} plan: max rel err {err:.3e} > 1e-5")
        print(f"relax: K2 against its plain version on the {pname} plan (n={plan.n}, L offsets "
              f"{plan.L.offsets}, U offsets {plan.U.offsets}): max_rel_err {err:.3e}")
        errs["neumann_sweep"] = max(errs["neumann_sweep"], (y - ref).abs().max().item())
    D = Ms["cg+poly"].state
    y, ref = dia_spmv(D, v), dia_spmv_plain(D.data, D.offsets, v)
    torch.cuda.synchronize()
    err = rel_err(y, ref)
    check(err <= 1e-5, f"relax: K1 on poly's matrix: max rel err {err:.3e}")
    errs["dia_spmv"] = (y - ref).abs().max().item()
    print(f"relax: K1 against its plain version on poly's fp32 matrix: max_rel_err {err:.3e}")
    errs["dia_spmv"] = max(errs["dia_spmv"], check_k1_on(np, torch, dev, D, "relax poly"))
    print(f"relax: phase time {time.perf_counter() - t_phase:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# The direct solvers, ilutp, arms and the communication-avoiding methods
# (phases 30-31)
# ---------------------------------------------------------------------------

# JAX's counts on the CPU for phase 31 at the card's sizes
# (scripts/jax_krylov_reference.py 31; solve_ir with 6 Neumann sweeps, rtol
# 1e-8; the pivot cells through solve, fp64; "128^3 ..." with ILU(0))
JAX_CPU_DIRECT = {
    "gmres30+ilutp coupled3d_25": 27, "gmres30+ilutp convdiff_256": 320,
    "ilutp pivot n=128 6 sweeps": 14, "ilutp pivot n=128 exact": 1,
    "gmres30+arms convdiff_256": 11, "gmres30+arms aniso_256": 18,
    "cg+ilu0 128^3": 194, "pipecg+ilu0 128^3": 290, "gmres30+ilu0 128^3": 256,
    "cagmres30+ilu0 128^3": 256, "dist pipecg+bjilu 128^3": 251,
}
# the pivot system's exact cell: JAX's own test asserts at most 5
PIVOT_EXACT_LIMIT = 5
DIRECT_COUNTERS = ("dia_spmv", "hyb_spmv")


def tiny_diagonal(lt, np, n=128):
    """``tests/test_ilu.py: test_robust_on_tiny_diagonal``'s system (50
    diagonal entries of 1e-14, a sub- and a superdiagonal): its pivoted
    factors are exact, their triangular solves grow exponentially with n,
    so it stays at the test's n = 128."""
    import scipy.sparse as sp
    d = np.r_[np.full(50, 1e-14), np.ones(n - 50)]
    return lt.CSR.from_scipy((sp.diags(d) + 0.5 * sp.diags(np.ones(n - 1), 1)
                              + 0.3 * sp.diags(np.ones(n - 1), -1)).tocsr())


def schedule_line(state):
    """Levels and slots of an lu apply state's two schedules, and their
    layout."""
    sl, su = state[0], state[1]
    return (f"{type(sl).__name__} L {sl.nlevels} levels {sl.slots} slots, U {su.nlevels} "
            f"levels {su.slots} slots")


def device_launches(torch, fn):
    """The device launches (kernels and copies) of one call of ``fn``, from
    torch.profiler recording the device alone (an exact apply runs tens of
    thousands; recording the host ops too costs minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def apply_time(torch, fn, v, reps=3, launches=True):
    """(the median host seconds of ``reps`` synchronized calls of fn(v), and
    with ``launches`` the device launches of one call, else None)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(v)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (sorted(times)[len(times) // 2],
            device_launches(torch, lambda: fn(v)) if launches else None)


def direct_cell(lt, np, torch, dev, counters, card, name, A, x_tol):
    """solve(method="direct") on A, b = 1: nits 1, true relres ≤ 1e-9
    (scipy), x against scipy's spsolve (≤ x_tol where given); the
    factorization split (AMD, symbolic, numeric), the factor's nnz, the
    schedules, one apply's time and device launches; only K1 / K3 launch
    (the two residual products).  The solve's own factorization is kept
    (``FactorMemo``) for the PC whose apply is timed.  Returns the lu PC."""
    import scipy.sparse.linalg as spla
    from lssp_tpu_torch import native
    from lssp_tpu_torch.pc import lu as lu_pc
    S = A.to_scipy()
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float64, device=dev)
    for fn in counters:
        fn.launches = 0
    memo = FactorMemo(lu_pc, "splu_factor")
    with Timers(native, "amd_order", "mf_symbolic", "mf_numeric", "splu") as tm, memo:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.solve(A, b, method="direct")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        f = memo.last
        M = lt.pc.setup(A, "lu", device=dev)        # the same factors, scheduled again
    xh = x.cpu().numpy()
    rr = float(np.linalg.norm(1.0 - S @ xh) / np.sqrt(n))
    t0 = time.perf_counter()
    xs = spla.spsolve(S.tocsc(), np.ones(n))
    sp_s = time.perf_counter() - t0
    dx = float(np.linalg.norm(xh - xs) / np.linalg.norm(xs))
    f_nnz = f.L.nnz + f.U.nnz
    z = M(b)
    same = repeat_equal(torch, lambda: M(b), z, 2)
    t_apply, nl = apply_time(torch, M, b)
    print(f"direct {name} n={n} [{card}]: nits {info.nits}, true relres {rr:.3e}, x vs spsolve "
          f"{dx:.3e} (spsolve {sp_s:.2f} s), solve {wall:.2f} s with factor: AMD "
          f"{tm.seconds['amd_order']:.2f} s, symbolic {tm.seconds['mf_symbolic']:.2f} s, numeric "
          f"{tm.seconds['mf_numeric'] + tm.seconds['splu']:.2f} s; factor nnz {f_nnz} (fill "
          f"{f_nnz / A.nnz:.1f}); {schedule_line(M.state)}; one apply {t_apply * 1e3:.1f} ms, "
          f"{nl} device launches, repeats bitwise equal {same}; launches {launches}")
    check(info.nits == 1 and info.converged, f"direct {name}: nits {info.nits}, converged "
          f"{info.converged}")
    check(rr <= 1e-9, f"direct {name}: true relres {rr:.3e} > 1e-9")
    check(x_tol is None or dx <= x_tol, f"direct {name}: x vs spsolve {dx:.3e} > {x_tol}")
    check(same, f"direct {name}: repeated exact applies differ")
    check(any(launches[k] > 0 for k in DIRECT_COUNTERS),
          f"direct {name}: no residual product launched K1 / K3")
    check(all(v == 0 for k, v in launches.items() if k not in DIRECT_COUNTERS),
          f"direct {name}: kernels other than K1 / K3 launched: {launches}")
    return M


def phase_direct(lt, np, torch, dev, counters, card):
    """Phase 30: the direct path (fp64 unless noted).  solve(method="direct")
    on the 2-D Laplacian 512² (the multifrontal engine), coupled3d_25 and
    convdiff_rot_128; Solver(method="direct") on 512², one factorization
    for 3 right-hand sides, and its solve_multi (k = 8, each column its
    single solve); solve_ir(method="direct") (fp32 LU inner) on 512²;
    solve_lsq on the tall [L; 0.1·I], L = laplacian_2d(128), by both
    routes, the host Givens QR last, after every timed apply.  K1 / K3
    against their plain versions on the residual products' matrices at the
    path's dtypes.  Returns {kernel: max abs err}."""
    import scipy.sparse.linalg as spla
    from lssp_tpu_torch import native
    t_phase = time.perf_counter()
    errs = {"dia_spmv": 0.0, "hyb_spmv": 0.0}
    tall = tall_system(lt, np, 128)
    St = tall.to_scipy()
    bh = St @ np.ones(St.shape[1])
    A = lt.sparse.laplacian_2d(512)
    n = A.shape[0]
    direct_cell(lt, np, torch, dev, counters, card, "laplacian_2d(512)", A, 1e-8)
    for name in ("coupled3d_25", "convdiff_rot_128"):
        V = lt.sparse.read_matrix_market(os.path.join(HERE, "benchmarks", "matrices",
                                                      name + ".mtx.gz"))
        direct_cell(lt, np, torch, dev, counters, card, name, V, None)
        Vd = lt.solvers.facade._prepare_matrix(V, device=dev)[1]
        if isinstance(Vd, lt.HYB):
            v = torch.from_numpy(np.random.default_rng(30).uniform(-1, 1, V.shape[0])).to(dev)
            err, abs_err = check_k3(torch, Vd, v, v, 1e-12, f"direct {name}")
            errs["hyb_spmv"] = max(errs["hyb_spmv"], abs_err)
            print(f"direct {name}: K3 float64 against its plain version: max_rel_err {err:.3e}")
        else:
            errs["dia_spmv"] = max(errs["dia_spmv"], check_k1_on(
                np, torch, dev, Vd, f"direct {name}", dtypes=(torch.float64,)))
    # the 512² residuals run in fp64 (direct) and fp32 (solve_ir's inner)
    errs["dia_spmv"] = max(errs["dia_spmv"], check_k1_on(
        np, torch, dev, lt.solvers.facade._prepare_matrix(A, device=dev)[1], "direct 512^2"))
    # the lifecycle: one factorization, three right-hand sides
    rng = np.random.default_rng(31)
    calls = {"n": 0}
    inner = native.mf_numeric

    def counted(*a, **k):
        calls["n"] += 1
        return inner(*a, **k)
    native.mf_numeric = counted
    try:
        t0 = time.perf_counter()
        s = lt.Solver(method="direct", device=dev).assemble(A)
        assemble_s = time.perf_counter() - t0
        walls = []
        for j in range(3):
            bj = torch.from_numpy(rng.standard_normal(n)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xj = s.solve(bj)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rj = np.linalg.norm(bj.cpu().numpy() - A.to_scipy() @ xj.cpu().numpy())
            check(rj <= 1e-9 * np.linalg.norm(bj.cpu().numpy()) and s.nits == 1,
                  f"Solver direct rhs {j}: relres {rj:.3e}")
        B = torch.from_numpy(rng.standard_normal((n, 8))).to(dev)
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X = s.solve_multi(B)
        torch.cuda.synchronize()
        multi_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        multi_nits = s.info.nits
        cols = [s.solve(B[:, c]) for c in range(8)]
    finally:
        native.mf_numeric = inner
    check(calls["n"] == 1, f"Solver direct: {calls['n']} numeric factorizations")
    dxm = max(float((X[:, c] - cols[c]).abs().max() / cols[c].abs().max()) for c in range(8))
    print(f"Solver direct 512^2 [{card}]: assemble (factor included) {assemble_s:.2f} s, "
          f"numeric factorizations {calls['n']} for 3 + 8 single solves and a k=8 block, "
          f"re-solves {', '.join(f'{w:.3f}' for w in walls)} s; solve_multi k=8 {multi_s:.3f} s, "
          f"nits {multi_nits}, max column rel diff from its single solve {dxm:.3e}, launches "
          f"{launches}")
    check(dxm <= 1e-12, f"solve_multi direct: a column differs from its single solve by {dxm:.3e}")
    check(bool(np.all(multi_nits == 1)), f"solve_multi direct: nits {multi_nits}")
    check(launches["dia_spmm"] > 0 and all(v == 0 for k, v in launches.items()
                                           if k != "dia_spmm"),
          f"solve_multi direct: launches {launches}")
    # mixed precision: the fp32 LU inner (the fp32 matrix's own
    # factorization), fp64 outer
    for fn in counters:
        fn.launches = 0
    b = torch.ones(n, dtype=torch.float64, device=dev)
    with Timers(native, "amd_order", "mf_symbolic", "mf_numeric", "splu") as tm, \
            InnerRounds() as rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.solve_ir(A, b, method="direct",
                              options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    M32 = lt.prepare_ir(A, method="direct", device=dev)[4]   # solve_ir's, memoized
    t32, _ = apply_time(torch, M32, b.to(torch.float32), launches=False)
    factor_s = sum(tm.seconds.values())
    print(f"solve_ir direct 512^2 [{card}]: outer rounds {rounds.count}, inner its {info.nits}, "
          f"true relres {rr:.3e}, {wall:.2f} s with the fp32 matrix's factorization (AMD "
          f"{tm.seconds['amd_order']:.2f} s, symbolic {tm.seconds['mf_symbolic']:.2f} s, numeric "
          f"{tm.seconds['mf_numeric'] + tm.seconds['splu']:.2f} s), {wall - factor_s:.2f} s "
          f"without it; fp32 apply {t32 * 1e3:.1f} ms, launches {launches}")
    check(info.converged and rr <= 1e-8, f"solve_ir direct: relres {rr:.3e}")
    check(M32.state[0].vals.dtype == torch.float32, "solve_ir direct: the inner LU is not fp32")
    check_only(launches, {"dia_spmv"}, "solve_ir direct")
    # direct least squares on the tall Tikhonov system
    atb = St.T @ bh
    xs = spla.spsolve((St.T @ St).tocsc(), atb)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _ = lt.solve_lsq(tall, torch.from_numpy(bh).to(dev), method="normal")
    torch.cuda.synchronize()
    normal_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()), f"solve_lsq normal: launches {launches}")
    # the host Givens QR (numpy and C++, no device work but x's copy)
    t0 = time.perf_counter()
    xq, _ = lt.solve_lsq(tall, torch.from_numpy(bh).to(dev), method="qr")
    qr_s = time.perf_counter() - t0
    for method, xt, secs in (("normal", x, normal_s), ("qr", xq, qr_s)):
        xh = xt.cpu().numpy()
        nrel = float(np.linalg.norm(St.T @ (bh - St @ xh)) / np.linalg.norm(atb))
        dx = float(np.linalg.norm(xh - xs) / np.linalg.norm(xs))
        print(f"solve_lsq {method} [laplacian_2d(128); 0.1 I] {St.shape[0]}x{St.shape[1]} "
              f"[{card}]: {secs:.2f} s, ||A^T(b-Ax)||/||A^T b|| {nrel:.3e}, x vs "
              f"spsolve(A^T A, A^T b) {dx:.3e}, x on {xt.device}")
        check(xt.device.type == "cuda", f"solve_lsq {method}: x on {xt.device}")
        check(nrel <= 1e-10 and dx <= 1e-8, f"solve_lsq {method}: normal relres {nrel:.3e}, "
              f"x vs spsolve {dx:.3e}")
    print(f"direct: phase time {time.perf_counter() - t_phase:.1f} s")
    return errs


class FactorMemo:
    """Inside it, the host factorization ``module.name`` (``pc/ilu``'s
    ``ilutp_factor``, ``pc/lu``'s ``splu_factor``) returns what it already
    made of the same matrix (the same values and options) instead of
    factoring again; both are deterministic, so a second PC of one matrix
    (the transposed apply of ``bicg``, the apply timed after a solve) gets
    the same factors.  ``last`` is the latest result."""

    def __init__(self, module, name):
        self.module, self.name, self.cache, self.hits, self.last = module, name, {}, 0, None

    def __enter__(self):
        import zlib
        self.fn = getattr(self.module, self.name)

        def memo(A, **kw):
            key = (A.shape, zlib.crc32(A.indptr), zlib.crc32(A.indices),
                   zlib.crc32(A.data.astype("float64")), repr(sorted(kw.items())))
            if key in self.cache:
                self.hits += 1
            else:
                self.cache[key] = self.fn(A, **kw)
            self.last = self.cache[key]
            return self.last
        setattr(self.module, self.name, memo)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def ir_cell(lt, np, torch, dev, counters, card, cell, A, method, pc, allowed, restart=30,
            pc_options=None):
    pc_options = pc_options or lt.PCOptions(ilu_sweeps=6)
    """A solve_ir cell of phase 31, b = 1, rtol 1e-8: its count against
    ``JAX_CPU_DIRECT`` + 15 %, true relres ≤ 1e-8, only ``allowed``
    kernels; the setup apart.  Returns (info, the inner PC, setup s,
    warm s, launches)."""
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000, restart=restart)
    t0 = time.perf_counter()
    M32 = lt.prepare_ir(A, method=method, pc=pc, pc_options=pc_options, device=dev)[4]
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    for fn in counters:
        fn.launches = 0
    with InnerRounds() as rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = lt.solve_ir(A, b, method=method, pc=pc, options=opts, pc_options=pc_options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    ref = JAX_CPU_DIRECT[cell]
    limit = count_limit(ref)
    its = max(info.nits, 1)
    print(f"{cell} solve_ir ({M32.name if M32 is not None else 'none'}) [{card}]: inner its "
          f"{info.nits} (JAX CPU {ref}, limit {limit}), outer rounds {rounds.count}, setup "
          f"{setup_s:.2f} s, solve {wall:.2f} s, true relres {rr:.3e}, launches an inner "
          f"iteration {', '.join(f'{k} {v / its:.2f}' for k, v in launches.items() if v)}")
    check(info.converged and rr <= 1e-8, f"{cell}: not converged (relres {rr:.3e})")
    check(info.nits <= limit, f"{cell}: {info.nits} inner its > {limit}")
    check_only(launches, allowed, cell)
    return info, M32, setup_s, wall, launches


def check_k2_plan(lt, np, torch, dev, plan, name, tol):
    """K2 against its plain version on one plan; returns the max abs err."""
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply, neumann_apply_plain
    v = torch.from_numpy(np.random.default_rng(32).uniform(-1, 1, plan.n)).to(
        device=dev, dtype=plan.dtype)
    y, ref = fused_neumann_apply(plan, v), neumann_apply_plain(plan, v)
    torch.cuda.synchronize()
    err, abs_err = rel_err(y, ref), (y - ref).abs().max().item()
    check(bool(torch.isfinite(y).all()) and err <= tol,
          f"{name}: K2 max rel err {err:.3e} > {tol:.0e}")
    print(f"{name}: K2 against its plain version ({str(plan.dtype)[6:]}, n={plan.n}): "
          f"max_rel_err {err:.3e} max_abs_err {abs_err:.3e}")
    return abs_err


def arms_cells(lt, np, torch, dev, counters, card):
    """solve_ir gmres(30) + arms on the convection-diffusion and the
    anisotropic Poisson 256²: the levels, the coarse n and its schedule,
    the setup and one apply's time, then the solve."""
    for kind, A in (("convdiff", lt.sparse.convection_diffusion_2d(256)),
                    ("aniso", lt.sparse.anisotropic_poisson_2d(256, 0.01))):
        t0 = time.perf_counter()
        M32 = lt.prepare_ir(A, method="gmres", pc="arms", pc_options=lt.PCOptions(ilu_sweeps=6),
                            device=dev)[4]
        setup_s = time.perf_counter() - t0
        v = torch.ones(A.shape[0], dtype=torch.float32, device=dev)
        t_apply, _ = apply_time(torch, M32, v, reps=1, launches=False)
        levels, coarse = M32.state
        print(f"arms {kind} 256^2 [{card}]: {len(levels)} levels, coarse n "
              f"{coarse[2].numel()}, coarse {schedule_line(coarse)}, "
              f"setup {setup_s:.2f} s, one apply {t_apply * 1e3:.1f} ms")
        ir_cell(lt, np, torch, dev, counters, card, f"gmres30+arms {kind}_256", A, "gmres",
                "arms", {"dia_spmv"})


def phase_ilutp_arms_ca(lt, np, torch, dev, counters, card):
    """Phase 31: ilutp, arms and the communication-avoiding methods.
    solve_ir gmres(30) + ilutp (K2, 6 sweeps) on coupled3d_25 and the
    convection-diffusion 256², with the columns the pivoting moved, K2 on
    the permuted plans (fp32 and fp64) and, through bicg + ilutp, on the
    transposed plan; the pivot system (n = 128) through solve gmres fp64
    with 6 sweeps and exact; solve_ir gmres(30) + arms on the
    convection-diffusion and the anisotropic Poisson 256²; solve_ir +
    ILU(0) on 128³ with pipecg beside cg and cagmres beside gmres(30);
    dist_solve_ir pipecg + bjilu on 128³ over 8 shards (only K4, one
    reduction over the shards an iteration); per column, solve_multi fp64
    48³, k = 4, pipecg and cagmres.  Returns {kernel: max abs err}."""
    from lssp_tpu_torch.ops.neumann import plan_fused_neumann
    from lssp_tpu_torch.parallel import dist_ops
    t_phase = time.perf_counter()
    errs = {"neumann_sweep": 0.0, "dist_spmv_ext": 0.0}
    c3 = lt.sparse.read_matrix_market(os.path.join(HERE, "benchmarks", "matrices",
                                                   "coupled3d_25.mtx.gz"))
    cd = lt.sparse.convection_diffusion_2d(256)
    from lssp_tpu_torch.pc import ilu as ilu_pc
    with FactorMemo(ilu_pc, "ilutp_factor") as memo:
        for cell, A, allowed in (("gmres30+ilutp coupled3d_25", c3,
                                  {"hyb_spmv", "fused_neumann_apply"}),
                                 ("gmres30+ilutp convdiff_256", cd,
                                  {"dia_spmv", "fused_neumann_apply"})):
            info, M32, _, _, launches = ir_cell(lt, np, torch, dev, counters, card, cell, A,
                                                "gmres", "ilutp", allowed)
            perm = M32.state[2].cpu().numpy()
            moved = int((perm != np.arange(len(perm))).sum())
            print(f"{cell}: the pivoting moved {moved} columns; K2 "
                  f"{launches['fused_neumann_apply']} launches on the permuted plan")
            errs["neumann_sweep"] = max(errs["neumann_sweep"], check_k2_plan(
                lt, np, torch, dev, M32.state[0], f"{cell} permuted fp32 plan", 1e-5))
            L, U, _ = memo.last
            errs["neumann_sweep"] = max(errs["neumann_sweep"], check_k2_plan(
                lt, np, torch, dev, plan_fused_neumann(L, U, 6, dtype=torch.float64,
                                                       device=dev),
                f"{cell} permuted fp64 plan", 1e-12))
        # M⁻ᵀ: bicg + ilutp on the convection-diffusion (the factors reused)
        opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000)
        six = lt.PCOptions(ilu_sweeps=6)
        Mt = lt.prepare_ir(cd, method="bicg", pc="ilutp", pc_options=six, device=dev)[4]
        plans = transposed_plans(dataclasses.replace(Mt, state=Mt.state[0]))
        check(len(plans) == 1, "bicg + ilutp: no transposed K2 plan")
        for fn in counters:
            fn.launches = 0
        with TransposedLaunches(plans) as tl:
            x, info = lt.solve_ir(cd, torch.ones(cd.shape[0], dtype=torch.float64, device=dev),
                                  method="bicg", pc="ilutp", options=opts, pc_options=six)
            torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        rr = true_relres(cd, x, np)
        print(f"bicg+ilutp convdiff_256 solve_ir [{card}]: inner its {info.nits}, true relres "
              f"{rr:.3e}, K2 {launches['fused_neumann_apply']} launches, {tl.count} on the "
              f"transposed plan (factor reused {memo.hits} times)")
        check(info.converged and rr <= 1e-8 and tl.count > 0, "bicg + ilutp on the card")
        check_only(launches, {"dia_spmv", "fused_neumann_apply"}, "bicg + ilutp")
        errs["neumann_sweep"] = max(errs["neumann_sweep"], check_k2_plan(
            lt, np, torch, dev, plans[0], "bicg+ilutp transposed fp32 plan", 1e-5))
    # the pivot path
    P = tiny_diagonal(lt, np)
    for sweeps, cell in ((6, "ilutp pivot n=128 6 sweeps"), (0, "ilutp pivot n=128 exact")):
        for fn in counters:
            fn.launches = 0
        pco = lt.PCOptions(ilu_sweeps=sweeps)
        x, info = lt.solve(P, torch.ones(128, dtype=torch.float64, device=dev),
                           method="gmres", pc="ilutp", options=lt.SolverOptions(maxit=200),
                           pc_options=pco)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        M = lt.pc.setup(P, "ilutp", pco, device=dev)
        moved = int((M.state[2].cpu().numpy() != np.arange(128)).sum())
        res = float(np.linalg.norm(1.0 - P.to_scipy() @ x.cpu().numpy()))
        ref = JAX_CPU_DIRECT[cell]
        limit = PIVOT_EXACT_LIMIT if sweeps == 0 else count_limit(ref)
        print(f"{cell} solve gmres fp64 [{card}]: its {info.nits} (JAX CPU {ref}, limit "
              f"{limit}), moved columns {moved}, residual {res:.3e}, launches {launches}")
        check(moved > 0, f"{cell}: the pivoting moved no column")
        check(info.converged and res < 1e-6 and info.nits <= limit, f"{cell}: its {info.nits}")
        if sweeps:
            check(launches["fused_neumann_apply"] > 0, f"{cell}: K2 never launched")
            errs["neumann_sweep"] = max(errs["neumann_sweep"], check_k2_plan(
                lt, np, torch, dev, M.state[0], f"{cell} fp64 plan", 1e-12))
    arms_cells(lt, np, torch, dev, counters, card)
    # the communication-avoiding methods beside their classical forms
    A = lt.sparse.laplacian_3d(128)
    counts = {}
    for cell, method in (("cg+ilu0 128^3", "cg"), ("pipecg+ilu0 128^3", "pipecg"),
                         ("gmres30+ilu0 128^3", "gmres"), ("cagmres30+ilu0 128^3", "cagmres")):
        counts[method] = ir_cell(lt, np, torch, dev, counters, card, cell, A, method, "ilu0",
                                 {"dia_spmv", "fused_neumann_apply"})[0].nits
    print(f"128^3 solve_ir + ilu0 [{card}]: pipecg - cg = {counts['pipecg'] - counts['cg']}, "
          f"cagmres - gmres(30) = {counts['cagmres'] - counts['gmres']} inner its")
    # distributed pipecg: one reduction over the shards an iteration
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    psums = {"n": 0}
    orig = dist_ops.psum

    def counted(partials):
        psums["n"] += 1
        return orig(partials)
    cell = "dist pipecg+bjilu 128^3"
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    for fn in counters:
        fn.launches = 0
    dist_ops.psum = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with InnerRounds() as rounds:
            x, info = lt.dist_solve_ir(A, b, method="pipecg", pc="bjilu", mesh=mesh,
                                       options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0,
                                                                maxit=2000),
                                       pc_options=lt.PCOptions(ilu_sweeps=6))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dist_ops.psum = orig
    launches = {fn.__name__: fn.launches for fn in counters}
    rr = true_relres(A, x, np)
    ref = JAX_CPU_DIRECT[cell]
    limit = count_limit(ref)
    # outside the iterations: ‖b‖ and the first residual's norm, then each
    # round the inner ‖b‖, ‖r0‖ and final ‖r‖ and the outer residual's norm
    outside = 2 + 4 * rounds.count
    print(f"{cell} over 8 shards [{card}]: inner its {info.nits} (JAX CPU {ref}, limit "
          f"{limit}), first call {wall:.2f} s, true relres {rr:.3e}, K4 "
          f"{launches['dia_spmv_ext'] / max(info.nits, 1):.2f} launches an inner iteration, "
          f"{psums['n']} reductions over the shards in {rounds.count} rounds: "
          f"{(psums['n'] - outside) / max(info.nits, 1):.2f} an inner iteration")
    check(info.converged and rr <= 1e-8 and info.nits <= limit, f"{cell}: its {info.nits}")
    check_only(launches, {"dia_spmv_ext"}, cell)
    check(psums["n"] == info.nits + outside, f"{cell}: {psums['n']} reductions over the shards "
          f"for {info.nits} inner its")
    prep = list(A._dist_cache.values())[-1]
    errs["dist_spmv_ext"] = check_dist_path(lt, np, torch, dev, prep, cell)[0]
    # per column
    A48 = lt.sparse.laplacian_3d(48)
    B = serving_block(np, torch, dev, A48.shape[0], k=4)
    opts = lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0, maxit=2000, restart=30)
    for method in ("pipecg", "cagmres"):
        for fn in counters:
            fn.launches = 0
        six = lt.PCOptions(ilu_sweeps=6)
        X, info = lt.solve_multi(A48, B, method=method, pc="ilu0", options=opts, pc_options=six)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        singles = [lt.solve(A48, B[:, c], method=method, pc="ilu0", options=opts,
                            pc_options=six)[1].nits for c in range(4)]
        rr = block_relres(A48, X, B, np)
        print(f"per-column 48^3 solve_multi {method}+ilu0 fp64 k=4: nits {info.nits}, single "
              f"solves {singles}, true relres max {rr.max():.3e}")
        check(bool(np.all(info.converged)), f"per-column {method}: not every column converged")
        check((np.abs(info.nits - np.array(singles)) <= 1).all(),
              f"per-column {method}: counts {info.nits} against single solves {singles}")
        check_only(launches, {"dia_spmm", "neumann_block_apply"}, f"per-column {method}")
    print(f"ilutp / arms / communication-avoiding: phase time "
          f"{time.perf_counter() - t_phase:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# the library yardstick and the bound of every kernel in the JSON line
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12


def bound(nbytes, flops, dtype_peak):
    """The least time the card could take: the larger of the bytes over
    3.35 TB/s and the operations over the type's peak."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / dtype_peak * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations")


FP32_PEAK = 67e12


def csr_tensor(np, torch, S, dev, dtype):
    """A scipy CSR as a torch.sparse_csr_tensor on the card (int32 indices)."""
    S = S.tocsr()
    return torch.sparse_csr_tensor(torch.from_numpy(S.indptr.astype(np.int32)),
                                   torch.from_numpy(S.indices.astype(np.int32)),
                                   torch.from_numpy(S.data), size=S.shape).to(
        device=dev, dtype=dtype)


def factor_csr(np, F, n):
    """A Neumann plan factor (band plus strays) as a scipy CSR."""
    import scipy.sparse as sp
    band = F.band.cpu().double().numpy()
    rows, cols, vals = [], [], []
    for d, off in enumerate(F.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i), cols.append(i + off), vals.append(band[d, i])
    if F.stray_ptr is not None:
        ptr = F.stray_ptr.cpu().numpy().astype(np.int64)
        rows.append(np.repeat(np.arange(n), np.diff(ptr)))
        cols.append(F.stray_cols.cpu().numpy())
        vals.append(F.stray_vals.cpu().double().numpy())
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    keep = v != 0
    return sp.csr_matrix((v[keep], (r[keep], c[keep])), shape=(n, n))


def library_ms(torch, fn):
    """Device ms per call of a PyTorch library call, from a CUDA graph replay
    as the kernels' ``ms``; a call that cannot be captured in a graph is
    timed with CUDA events around host-issued calls instead, and said so."""
    try:
        return graph_ms(fn, calls=10, samples=10)
    except RuntimeError as e:
        print(f"library call not capturable ({str(e).splitlines()[0][:120]}); timed "
              "host-issued")
        torch.cuda.synchronize()
        return cuda_ms(fn, inner=10)


def phase_library(lt, np, torch, dev, card):
    """For each kernel of the JSON line, at the shape its entry reports: the
    time of the one PyTorch call that computes the same function (cuSPARSE
    through torch.sparse; the Neumann apply as its 12 addmm), its output
    against the kernel's, and the kernel's bound.  No solve path calls any
    of these library functions."""
    from lssp_tpu_torch.ops.dia_spmv import dia_spmm, dia_spmv
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext, dia_spmv_ext
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmv
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply, plan_fused_neumann
    from lssp_tpu_torch.parallel import halo_exchange, partition_csr_dia
    from lssp_tpu_torch.pc.ilu_host import iluk_factor
    f32 = torch.float32
    rng = np.random.default_rng(20)
    out = {}

    def vec(n, k=None):
        shape = (n,) if k is None else (n, k)
        return torch.from_numpy(rng.uniform(-1, 1, shape)).to(device=dev, dtype=f32)

    def record(name, kernel_y, lib, nbytes, flops):
        y_lib = lib()
        torch.cuda.synchronize()
        diff = rel_err(y_lib.reshape(kernel_y.shape), kernel_y)
        check(diff <= 1e-4, f"library {name}: the library call differs from the kernel by "
              f"{diff:.3e}, not the same function")
        out[name] = dict(library_ms=library_ms(torch, lib), **bound(nbytes, flops, FP32_PEAK))
        print(f"library {name} [{card}]: {out[name]['library_ms'] * 1e3:.2f} us, against the "
              f"kernel {diff:.1e}; bound {out[name]['bound_ms'] * 1e3:.2f} us "
              f"({out[name]['bound_by']})")

    # K1 at phase 2's out-of-L2 shape: laplacian_2d(2048), fp32
    A = lt.sparse.laplacian_2d(2048)
    n = A.shape[0]
    D = lt.sparse.csr_to_dia(A, device=dev).to(dtype=f32)
    C = csr_tensor(np, torch, A.to_scipy(), dev, f32)
    x = vec(n)
    nd = len(D.offsets)
    record("dia_spmv", dia_spmv(D, x), lambda: C @ x, (nd * n + 2 * n) * 4, 2 * A.nnz)
    del C, D, x
    # K2 at phase 3's out-of-L2 shape (and K2k at phase 14's): ILU(0) 128^3,
    # 6 sweeps, fp32, per apply
    A4 = lt.sparse.laplacian_3d(128)
    L4, U4 = iluk_factor(A4, level=0)
    plan = plan_fused_neumann(L4, U4, 6, dtype=f32, device=dev)
    n4 = A4.shape[0]
    Ls = csr_tensor(np, torch, factor_csr(np, plan.L, n4), dev, f32)
    Us = csr_tensor(np, torch, factor_csr(np, plan.U, n4), dev, f32)
    r = vec(n4)

    def neumann_lib(R):
        y = R
        for _ in range(6):
            y = torch.addmm(R, Ls, y, beta=1.0, alpha=-1.0)
        z0 = plan.invdiag[:, None] * y
        z = z0
        for _ in range(6):
            z = torch.addmm(z0, Us, z, beta=1.0, alpha=-1.0)
        return z

    record("neumann_sweep", fused_neumann_apply(plan, r), lambda: neumann_lib(r[:, None]),
           neumann_bytes(plan, 1, 4), neumann_flops(plan, 1))
    # K3 at phase 8's shape: 128^3 + strays, fp32
    A3 = strayed_grid(lt, np, 128, "3d", np.float64)
    H = lt.sparse.csr_to_hyb(A3, device=dev).to(dtype=f32)
    C3 = csr_tensor(np, torch, A3.to_scipy(), dev, f32)
    n3 = A3.shape[0]
    x3 = vec(n3)
    nd3 = len(H.dia.offsets)
    hyb_bytes = lambda k: (nd3 * n3 + 2 * k * n3) * 4 + H.nnz_rem * 12 + H.rem_block_ptr.numel() * 4
    record("hyb_spmv", hyb_spmv(H, x3), lambda: C3 @ x3, hyb_bytes(1), 2 * A3.nnz)
    X3 = vec(n3, 8)
    record("hyb_spmm", hyb_spmm(H, X3), lambda: C3 @ X3, hyb_bytes(8), 2 * 8 * A3.nnz)
    # K4 at phase 12's partition: 128^3 over 8 shards, fp32 (library: unpartitioned CSR)
    C4 = csr_tensor(np, torch, A4.to_scipy(), dev, f32)
    M = partition_csr_dia(A4, 8).to(device=dev, dtype=f32)
    P, R = M.nshards, M.rows_per_shard
    x4 = vec(P * R)
    xe = halo_exchange(x4.view(P, R), M.lo, M.hi)
    ext_bytes = lambda k: P * (len(M.offsets) * R + k * (R + M.lo + M.hi) + k * R) * 4
    record("dist_spmv_ext", dia_spmv_ext(M.data, M.offsets, xe, offsets_t=M.offsets_t),
           lambda: C4 @ x4, ext_bytes(1), 2 * A4.nnz)
    X4 = vec(P * R, 8)
    Xe = halo_exchange(X4.view(P, R, 8), M.lo, M.hi)
    record("dist_spmm_ext", dia_spmm_ext(M.data, M.offsets, Xe, offsets_t=M.offsets_t),
           lambda: C4 @ X4, ext_bytes(8), 2 * 8 * A4.nnz)
    # K1k and K2k at phase 14's shapes: 128^3, k = 8, fp32
    D4 = lt.sparse.csr_to_dia(A4, device=dev).to(dtype=f32)
    nd4 = len(D4.offsets)
    record("dia_spmm", dia_spmm(D4, X4), lambda: C4 @ X4, (nd4 * P * R + 2 * 8 * P * R) * 4,
           2 * 8 * A4.nnz)
    record("neumann_sweep_block", fused_neumann_apply(plan, X4), lambda: neumann_lib(X4),
           neumann_bytes(plan, 8, 4), neumann_flops(plan, 8))
    return out



# ---------------------------------------------------------------------------
# phases 32-34: the bf16 inner precision, utils/, the examples
# ---------------------------------------------------------------------------

# JAX's CPU counts for phase 32's held cell (scripts/jax_krylov_reference.py
# 32): solve_ir cg + ILU(0) with 6 Neumann sweeps, bf16 inner, inner_rtol
# 3e-2, max_outer 60, rtol 1e-8 on the 3-D Laplacian 64³
JAX_CPU_BF16 = {"cg+ilu0 64^3": 202}
# and on phase 8's stray recipe at 64³ (inner its, true relres): JAX's bf16
# BiCGSTAB diverges there, its GMRES and CG converge
JAX_CPU_BF16_HYB = {"bicgstab": (2122, 2.6e7), "gmres": (398, 2.0e-9), "cg": (172, 8.2e-9)}
BF16_ULP = 7.9e-3           # one bf16 ulp, relative (2⁻⁷ and a margin)


def bf16_err(torch, y, ref):
    """(max relative difference over the entries with |ref| ≥ 1e-3·max|ref|,
    max abs difference) of a bf16 kernel's output against its plain
    version."""
    y, ref = y.double(), ref.double()
    keep = ref.abs() >= 1e-3 * ref.abs().max()
    return (((y - ref).abs()[keep] / ref.abs()[keep]).max().item(),
            (y - ref).abs().max().item())


def check_bf16(torch, name, kernel, plain):
    """A bf16 kernel within one bf16 ulp of its plain version (both round
    the same float32 sum once).  Returns the max abs difference."""
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16, f"{name}: output {y.dtype}, not bfloat16")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    rel, abs_err = bf16_err(torch, y, ref)
    check(rel <= BF16_ULP, f"{name}: {rel:.3e} from its plain version, more than one bf16 ulp")
    print(f"{name}: against its plain version max_rel_err {rel:.3e} max_abs_err {abs_err:.3e}")
    return abs_err


def bf16_library(np, torch, S, dev, x):
    """The cuSPARSE product of a bf16 ``torch.sparse_csr_tensor``, timed as
    ``library_ms``; None (and why) where torch refuses bf16 there."""
    try:
        C = csr_tensor(np, torch, S, dev, torch.bfloat16)
        y = C @ x
        torch.cuda.synchronize()
        return library_ms(torch, lambda: C @ x), y
    except (RuntimeError, NotImplementedError) as e:
        print(f"library: torch refuses a bf16 sparse CSR product here: "
              f"{str(e).splitlines()[0][:160]}")
        return None, None


def bf16_kernel(np, torch, card, name, kernel, plain, nbytes, flops, S, dev, x):
    """One bf16 kernel alone: its agreement with its plain version, device
    and host times, GB/s and share of the bound (its bytes at 2 bytes an
    element), and the bf16 cuSPARSE call's time beside it."""
    err = check_bf16(torch, name, kernel, plain)
    t = timings(kernel, plain)
    lib, y_lib = bf16_library(np, torch, S, dev, x)
    if y_lib is not None:
        # cuSPARSE rounds the bf16 sums its own way: held normwise, to the
        # product's own rounding (nd·2⁻⁸ for a sum of nd bf16 terms)
        y = kernel().double()
        rel = ((y_lib.reshape(y.shape).double() - y).norm() / y.norm()).item()
        print(f"library {name}: normwise {rel:.2e} from the kernel")
        check(rel <= 0.1, f"library {name}: {rel:.3e} from the kernel, not the same function")
    b = bound(nbytes, flops, FP32_PEAK)
    print(f"{name} [{card}]: device {t['ms'] * 1e3:.2f} us "
          f"({nbytes / (t['ms'] * 1e-3) / 1e9:.1f} GB/s, {b['bound_ms'] / t['ms']:.1%} of the "
          f"{b['bound_ms'] * 1e3:.2f} us bound), plain {t['plain_ms'] * 1e3:.2f} us, library "
          f"{'refused' if lib is None else f'{lib * 1e3:.2f} us'}; issued from Python "
          f"{t['host_ms'] * 1e3:.2f} us")
    return dict(max_abs_err=err, library_ms=lib, **t, **b)


def reset(counters):
    for fn in counters:
        fn.launches = 0
        fn.by_dtype = {}
        if hasattr(fn, "by_route"):
            fn.by_route = {}


def bf16_launches(counters):
    return {fn.__name__: dict(fn.by_dtype) for fn in counters if fn.launches}


def check_ring_routes(counters, name):
    """Every bf16 launch of K1 / K3 (the wrappers that count by route) took
    the band ring.  Returns the routes, for the cell's line."""
    routes = {}
    for fn in counters:
        if hasattr(fn, "by_route") and fn.launches:
            bf, ring = fn.by_dtype.get("bf16", 0), fn.by_route.get("ring", 0)
            check(ring == bf, f"{name}: {fn.__name__} {bf} bf16 launches, {ring} on the ring "
                              f"(routes {fn.by_route})")
            routes[fn.__name__] = dict(fn.by_route)
    return routes


def check_ring_bitwise(torch, name, ring, rowwise):
    """The band ring's y against the rowwise kernel's on the same inputs:
    equal bit for bit (the same fused multiply-adds in the same order, one
    rounding)."""
    y, ref = ring(), rowwise()
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs().max().item()
    same = torch.equal(y.view(torch.int16), ref.view(torch.int16))
    print(f"{name}: ring against rowwise {'bitwise equal' if same else 'DIFFERS'} "
          f"(max difference {diff:.3e})")
    check(same, f"{name}: the ring's y differs from the rowwise kernel's by up to {diff:.3e}")


def ring_in_turns(card, name, ring, rowwise, bound_ms=None):
    """Device ms of the rowwise and ring kernels on the same inputs, taken
    in turns in one call (rowwise, ring, ring, rowwise); returns the means.
    The share of ``bound_ms`` is printed where the inputs pass the L2."""
    turns = [graph_ms(f) for f in (rowwise, ring, ring, rowwise)]
    row, ring_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2

    def share(t):
        return "" if bound_ms is None else f" ({bound_ms / t:.1%} of the bound)"
    print(f"{name} [{card}]: in turns rowwise / ring / ring / rowwise "
          f"{' / '.join(f'{t * 1e3:.2f}' for t in turns)} us; ring {ring_ms * 1e3:.2f} us"
          f"{share(ring_ms)}, rowwise {row * 1e3:.2f} us{share(row)}")
    return ring_ms, row


# the ring shapes timed beside the plan's own (T rows a tile, S stages)
RING_VARIANTS = [(T, S) for T in (512, 1024, 2048) for S in (2, 3, 4)]


def ring_variants(torch, card, name, shape, offsets, rem, run, rowwise, bound_ms):
    """Every (T, S) of ``RING_VARIANTS`` that fits, each held bitwise to the
    rowwise kernel and timed; the plan's own choice is marked."""
    from lssp_tpu_torch.ops.dia_spmv import band_tile_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    own = band_tile_plan(shape[0], shape[1], tuple(offsets), 2, False, rem, num_sms=sms)
    ref = rowwise()
    out = []
    for T, S in RING_VARIANTS:
        plan = band_tile_plan(shape[0], shape[1], tuple(offsets), 2, False, rem, T=T, S=S,
                              num_sms=sms)
        if plan.route != "ring":
            out.append(f"T{T} S{S} {plan.reason}")
            continue
        y = run(plan)
        torch.cuda.synchronize()
        check(torch.equal(y.view(torch.int16), ref.view(torch.int16)),
              f"{name} T{T} S{S}: the ring's y differs from the rowwise kernel's")
        t = graph_ms(lambda: run(plan))
        mark = " (the plan's)" if (T, S) == (own.T, own.S) else ""
        out.append(f"T{T} S{S} grid {plan.grid}: {t * 1e3:.2f} us ({bound_ms / t:.1%}){mark}")
    print(f"{name} ring variants [{card}], each bitwise the rowwise kernel's: " + "; ".join(out))


def phase_bf16(lt, np, torch, dev, counters, card):
    """Phase 32: the bf16 inner precision.  The six bf16 kernels alone at
    phase 2 / 7 / 11 / 14's shapes, then the bf16 paths: solve_ir cg +
    ILU(0) at 64³ (held to JAX's CPU count + 15 %) and 128³ (beside the
    fp32 solve), the strayed 128³ HYB with BiCGSTAB + ILU(0),
    dist_solve_ir cg + bjilu over 8 shards, and the k-rhs forms through
    solve_ir_multi / dist_solve_ir_multi per column (JAX's blockcg cannot
    carry bf16).  Counters reset before each path cell; each kernel
    checked on its solve's own bf16 matrix.  Returns the bf16 entries of
    the kernels line."""
    from lssp_tpu_torch.ops.dia_spmv import (ROWWISE, dia_spmm, dia_spmm_plain, dia_spmv,
                                             dia_spmv_plain)
    from lssp_tpu_torch.ops.dia_spmv_ext import (dia_spmm_ext, dia_spmm_ext_plain,
                                                 dia_spmv_ext, dia_spmv_ext_plain)
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm, hyb_spmm_plain, hyb_spmv, hyb_spmv_plain
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply, neumann_apply_plain
    from lssp_tpu_torch.parallel import halo_exchange, partition_csr_dia
    bf = torch.bfloat16
    t_phase = time.perf_counter()
    rng = np.random.default_rng(32)

    def vec(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape)).to(device=dev, dtype=bf)

    entries = {}
    # K1 at phase 2's JSON shape, the 2-D Laplacian 2048²
    A = lt.sparse.laplacian_2d(2048)
    D = lt.sparse.csr_to_dia(A, device=dev).to(dtype=bf)
    n, nd = A.shape[0], len(D.offsets)
    x, z = vec(n), vec(n)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, z)):
        reset(counters)
        check_bf16(torch, f"K1 bf16 laplacian_2d(2048) ({alpha}, {beta})",
                   lambda: dia_spmv(D, x, alpha, beta, zz),
                   lambda: dia_spmv_plain(D.data, D.offsets, x, alpha, beta, zz))
        check(dia_spmv.by_route == {"ring": 1}, f"K1 bf16 2048^2: routes {dia_spmv.by_route}")
        check_ring_bitwise(
            torch, f"K1 bf16 laplacian_2d(2048) ({alpha}, {beta})",
            lambda: dia_spmv(D, x, alpha, beta, zz),
            lambda: dia_spmv(D, x, alpha, beta, zz, plan=ROWWISE))
    entries["dia_spmv_bf16"] = bf16_kernel(
        np, torch, card, "K1 bf16 laplacian_2d(2048)", lambda: dia_spmv(D, x),
        lambda: dia_spmv_plain(D.data, D.offsets, x), (nd * n + 2 * n) * 2, 2 * A.nnz,
        A.to_scipy(), dev, x)
    e = entries["dia_spmv_bf16"]
    e["ms"], e["rowwise_ms"] = ring_in_turns(card, "K1 bf16 laplacian_2d(2048)",
                                             lambda: dia_spmv(D, x),
                                             lambda: dia_spmv(D, x, plan=ROWWISE), e["bound_ms"])
    e.update(kernel_route="ring", source="lssp_tpu_torch/csrc/band_ring.cuh")
    ring_variants(torch, card, "K1 bf16 laplacian_2d(2048)", A.shape, D.offsets, False,
                  lambda plan: dia_spmv(D, x, plan=plan), lambda: dia_spmv(D, x, plan=ROWWISE),
                  e["bound_ms"])
    del D, x, z
    # K3 at phase 7's first shape, the bench HYB matrix (2048² + strays)
    A = strayed_grid(lt, np, 2048, "2d", np.float64)
    H = lt.sparse.csr_to_hyb(A, device=dev).to(dtype=bf)
    n, nd = A.shape[0], len(H.dia.offsets)
    x, z = vec(n), vec(n)
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, z)):
        reset(counters)
        check_bf16(torch, f"K3 bf16 bench 2048^2+strays ({alpha}, {beta})",
                   lambda: hyb_spmv(H, x, alpha, beta, zz),
                   lambda: hyb_spmv_plain(H, x, alpha, beta, zz))
        check(hyb_spmv.by_route == {"ring": 1}, f"K3 bf16 2048^2: routes {hyb_spmv.by_route}")
        check_ring_bitwise(
            torch, f"K3 bf16 bench 2048^2+strays ({alpha}, {beta})",
            lambda: hyb_spmv(H, x, alpha, beta, zz),
            lambda: hyb_spmv(H, x, alpha, beta, zz, plan=ROWWISE))
    hyb_bytes = (nd * n + 2 * n) * 2 + H.nnz_rem * 10 + H.rem_block_ptr.numel() * 4
    entries["hyb_spmv_bf16"] = bf16_kernel(
        np, torch, card, "K3 bf16 bench 2048^2+strays", lambda: hyb_spmv(H, x),
        lambda: hyb_spmv_plain(H, x), hyb_bytes, 2 * A.nnz, A.to_scipy(), dev, x)
    e = entries["hyb_spmv_bf16"]
    e["ms"], e["rowwise_ms"] = ring_in_turns(card, "K3 bf16 bench 2048^2+strays",
                                             lambda: hyb_spmv(H, x),
                                             lambda: hyb_spmv(H, x, plan=ROWWISE), e["bound_ms"])
    e.update(kernel_route="ring", source="lssp_tpu_torch/csrc/band_ring.cuh")
    ring_variants(torch, card, "K3 bf16 bench 2048^2+strays", A.shape, H.dia.offsets, True,
                  lambda plan: hyb_spmv(H, x, plan=plan), lambda: hyb_spmv(H, x, plan=ROWWISE),
                  e["bound_ms"])
    k1_ms = entries["dia_spmv_bf16"]["ms"]
    print(f"K3 bf16 over K1 bf16 at the same band (ring): {e['ms'] / k1_ms - 1:+.1%}")
    del H, x, z
    # K4 at phase 11's 128³ over 8 shards, and the k-rhs forms at phase 14's
    # shapes (128³, k = 8; K3k on phase 8's strayed 128³)
    A4 = lt.sparse.laplacian_3d(128)
    M = partition_csr_dia(A4, 8).to(device=dev, dtype=bf)
    P, R = M.nshards, M.rows_per_shard
    x4, z4 = vec(P * R), vec(P, R)
    xe = halo_exchange(x4.view(P, R), M.lo, M.hi)
    check_bf16(torch, "K4 bf16 128^3 P=8 sweep (-1, 1, z)",
               lambda: dia_spmv_ext(M.data, M.offsets, xe, -1.0, 1.0, z4, offsets_t=M.offsets_t),
               lambda: dia_spmv_ext_plain(M.data, M.offsets, xe, -1.0, 1.0, z4))
    ext_bytes = lambda k: P * (len(M.offsets) * R + k * (R + M.lo + M.hi) + k * R) * 2
    entries["dist_spmv_ext_bf16"] = bf16_kernel(
        np, torch, card, "K4 bf16 128^3 P=8",
        lambda: dia_spmv_ext(M.data, M.offsets, xe, offsets_t=M.offsets_t),
        lambda: dia_spmv_ext_plain(M.data, M.offsets, xe), ext_bytes(1), 2 * A4.nnz,
        A4.to_scipy(), dev, x4)
    X4 = vec(P * R, 8)
    Xe = halo_exchange(X4.view(P, R, 8), M.lo, M.hi)
    entries["dist_spmm_ext_bf16"] = bf16_kernel(
        np, torch, card, "K4k bf16 128^3 P=8 k=8",
        lambda: dia_spmm_ext(M.data, M.offsets, Xe, offsets_t=M.offsets_t),
        lambda: dia_spmm_ext_plain(M.data, M.offsets, Xe), ext_bytes(8), 2 * 8 * A4.nnz,
        A4.to_scipy(), dev, X4)
    D4 = lt.sparse.csr_to_dia(A4, device=dev).to(dtype=bf)
    nd4, n4 = len(D4.offsets), A4.shape[0]
    # the 7-diagonal 128³ band (offsets ±16,384) on the ring: bitwise the
    # rowwise kernel's; no share of the bound (its 37.7 MB sit in the L2)
    v4, w4 = vec(n4), vec(n4)
    for alpha, beta, zz in ((1.0, 0.0, None), (0.25, 0.0, None), (-1.0, 1.0, w4)):
        reset(counters)
        check_bf16(torch, f"K1 bf16 laplacian_3d(128) ({alpha}, {beta})",
                   lambda: dia_spmv(D4, v4, alpha, beta, zz),
                   lambda: dia_spmv_plain(D4.data, D4.offsets, v4, alpha, beta, zz))
        check(dia_spmv.by_route == {"ring": 1}, f"K1 bf16 128^3: routes {dia_spmv.by_route}")
        check_ring_bitwise(
            torch, f"K1 bf16 laplacian_3d(128) ({alpha}, {beta})",
            lambda: dia_spmv(D4, v4, alpha, beta, zz),
            lambda: dia_spmv(D4, v4, alpha, beta, zz, plan=ROWWISE))
    ring_in_turns(card, "K1 bf16 laplacian_3d(128) (L2-resident)", lambda: dia_spmv(D4, v4),
                  lambda: dia_spmv(D4, v4, plan=ROWWISE))
    entries["dia_spmm_bf16"] = bf16_kernel(
        np, torch, card, "K1k bf16 128^3 k=8", lambda: dia_spmm(D4, X4),
        lambda: dia_spmm_plain(D4.data, D4.offsets, X4), (nd4 * n4 + 2 * 8 * n4) * 2,
        2 * 8 * A4.nnz, A4.to_scipy(), dev, X4)
    del M, xe, Xe, D4
    A3 = strayed_grid(lt, np, 128, "3d", np.float64)
    H3 = lt.sparse.csr_to_hyb(A3, device=dev).to(dtype=bf)
    n3, nd3 = A3.shape[0], len(H3.dia.offsets)
    # phase 8's strayed 128³ HYB on the ring, as the 128³ band above
    for alpha, beta, zz in ((1.0, 0.0, None), (-1.0, 1.0, w4)):
        reset(counters)
        check_bf16(torch, f"K3 bf16 128^3+strays ({alpha}, {beta})",
                   lambda: hyb_spmv(H3, v4, alpha, beta, zz),
                   lambda: hyb_spmv_plain(H3, v4, alpha, beta, zz))
        check(hyb_spmv.by_route == {"ring": 1}, f"K3 bf16 128^3: routes {hyb_spmv.by_route}")
        check_ring_bitwise(
            torch, f"K3 bf16 128^3+strays ({alpha}, {beta})",
            lambda: hyb_spmv(H3, v4, alpha, beta, zz),
            lambda: hyb_spmv(H3, v4, alpha, beta, zz, plan=ROWWISE))
    ring_in_turns(card, "K3 bf16 128^3+strays (L2-resident)", lambda: hyb_spmv(H3, v4),
                  lambda: hyb_spmv(H3, v4, plan=ROWWISE))
    del v4, w4
    X3 = vec(n3, 8)
    entries["hyb_spmm_bf16"] = bf16_kernel(
        np, torch, card, "K3k bf16 128^3+strays k=8", lambda: hyb_spmm(H3, X3),
        lambda: hyb_spmm_plain(H3, X3),
        (nd3 * n3 + 2 * 8 * n3) * 2 + H3.nnz_rem * 10 + H3.rem_block_ptr.numel() * 4,
        2 * 8 * A3.nnz, A3.to_scipy(), dev, X3)
    del H3, X3, X4
    print(f"phase 32 kernels alone: {time.perf_counter() - t_phase:.1f} s")

    # the bf16 paths: cg + ILU(0) at 64³ (held) and 128³
    kw = dict(inner_dtype=bf, inner_rtol=3e-2, max_outer=60,
              options=lt.SolverOptions(rtol=1e-8, atol=0, rbtol=0),
              pc_options=lt.PCOptions(ilu_sweeps=6))
    launches = {}
    for N in (64, 128):
        A = lt.sparse.laplacian_3d(N)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        prep = lt.prepare_ir(A, "cg", "ilu0", pc_options=kw["pc_options"], inner_dtype=bf,
                             device=dev)
        setup_s = time.perf_counter() - t0
        reset(counters)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = lt.solve_ir(A, b, method="cg", pc="ilu0", **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        by = bf16_launches(counters)
        routes = check_ring_routes(counters, f"bf16 {N}^3")
        rr = true_relres(A, x, np)
        for _ in range(2):                          # the second is the warm fp32 solve
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, i32 = lt.solve_ir(A, b, method="cg", pc="ilu0", pc_options=kw["pc_options"],
                                 options=kw["options"])
            torch.cuda.synchronize()
            w32 = time.perf_counter() - t0
        print(f"bf16 solve_ir cg+ilu0 {N}^3 [{card}]: inner its {info.nits} (fp32 inner "
              f"{i32.nits}), true relres {rr:.3e}, setup {setup_s:.3f} s, solve cold "
              f"{walls[0]:.3f} s, warm {walls[1]:.3f} s (fp32 warm {w32:.3f} s), launches {by}, "
              f"routes {routes}")
        check(rr <= 1e-8, f"bf16 {N}^3: true relres {rr:.3e} > 1e-8")
        check(set(by) == {"dia_spmv", "fused_neumann_apply"} and by["dia_spmv"].get("bf16", 0) > 0
              and set(by["fused_neumann_apply"]) == {"f32"},
              f"bf16 {N}^3: launches {by}: K1 in bf16 and K2 on its fp32 plan expected")
        if N == 64:
            launches["dia_spmv_bf16"] = by["dia_spmv"]["bf16"]
            ref = JAX_CPU_BF16["cg+ilu0 64^3"]
            check(info.nits <= count_limit(ref),
                  f"bf16 64^3: {info.nits} inner its > {count_limit(ref)} (JAX CPU {ref} + 15 %)")
            _, _, A32, _, M32 = prep
            check(A32.dtype == bf, f"bf16 64^3: the inner matrix is {A32.dtype}")
            v = vec(A32.shape[0])
            entries["dia_spmv_bf16"]["max_abs_err"] = max(
                entries["dia_spmv_bf16"]["max_abs_err"],
                check_bf16(torch, "K1 bf16 on the 64^3 solve's own matrix",
                           lambda: dia_spmv(A32, v), lambda: dia_spmv_plain(A32.data, A32.offsets, v)))
            z = fused_neumann_apply(M32.state, v)
            ref_z = neumann_apply_plain(M32.state, v.float()).to(bf)
            rel, _ = bf16_err(torch, z, ref_z)
            check(z.dtype == bf and rel <= BF16_ULP,
                  f"bf16 64^3: K2 on its fp32 plan with a bf16 r: {rel:.3e} from its plain version")
            print(f"bf16 64^3: K2 on the solve's fp32 plan, r and z in bf16: max_rel_err {rel:.3e}")

    # the HYB cells on phase 8's strayed 128³: GMRES(30) + ILU(0), held; and
    # BiCGSTAB + ILU(0), reported: JAX's own bf16 BiCGSTAB diverges on the
    # same recipe at 64³ (JAX_CPU_BF16_HYB), so the port is not held to it
    b3 = torch.ones(n3, dtype=torch.float64, device=dev)
    for method in ("gmres", "bicgstab"):
        reset(counters)
        t0 = time.perf_counter()
        x, info = lt.solve_ir(A3, b3, method=method, pc="ilu0",
                              **dict(kw, options=dataclasses.replace(kw["options"], restart=30)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by = bf16_launches(counters)
        routes = check_ring_routes(counters, f"bf16 hyb {method}")
        rr = true_relres(A3, x, np)
        print(f"bf16 solve_ir {method}+ilu0 128^3+strays (HYB) [{card}]: inner its {info.nits}, "
              f"true relres {rr:.3e}, {wall:.3f} s with setup, launches {by}, routes {routes}")
        check(by.get("hyb_spmv", {}).get("bf16", 0) > 0 and "dia_spmv" not in by,
              f"bf16 hyb {method}: launches {by}: K3 in bf16 expected")
        if method == "gmres":
            check(rr <= 1e-8, f"bf16 hyb gmres: true relres {rr:.3e} > 1e-8")
            launches["hyb_spmv_bf16"] = by["hyb_spmv"]["bf16"]
        else:
            print(f"bf16 hyb bicgstab: {'converged' if rr <= 1e-8 else 'not converged'}; "
                  f"JAX's CPU on the strayed 64^3: {JAX_CPU_BF16_HYB['bicgstab']}")
    _, _, A32, _, _ = lt.prepare_ir(A3, "bicgstab", "ilu0", pc_options=kw["pc_options"],
                                    inner_dtype=bf, device=dev)
    v = vec(n3)
    entries["hyb_spmv_bf16"]["max_abs_err"] = max(
        entries["hyb_spmv_bf16"]["max_abs_err"],
        check_bf16(torch, "K3 bf16 on the hyb solve's own matrix", lambda: hyb_spmv(A32, v),
                   lambda: hyb_spmv_plain(A32, v)))

    # the distributed cell: cg + bjilu over 8 shards of 128³
    mesh = lt.make_mesh(8, devices=[dev] * 8)
    b4 = torch.ones(n4, dtype=torch.float64, device=dev)
    reset(counters)
    t0 = time.perf_counter()
    x, info = lt.dist_solve_ir(A4, b4, method="cg", pc="bjilu", mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by = bf16_launches(counters)
    check_ring_routes(counters, "bf16 dist")
    rr = true_relres(A4, x, np)
    print(f"bf16 dist_solve_ir cg+bjilu 128^3 P=8 [{card}]: inner its {info.nits}, true relres "
          f"{rr:.3e}, {wall:.3f} s with setup, launches {by}")
    check(rr <= 1e-8, f"bf16 dist: true relres {rr:.3e} > 1e-8")
    check(set(by) == {"dia_spmv_ext"} and by["dia_spmv_ext"].get("bf16", 0) > 0,
          f"bf16 dist: launches {by}: only K4, in bf16, expected")
    launches["dist_spmv_ext_bf16"] = by["dia_spmv_ext"]["bf16"]
    (prep,) = [e for k, e in A4._dist_cache.items() if k[6] == str(bf)]
    Md = prep["M"]
    check(Md.data.dtype == bf, f"bf16 dist: the inner partition is {Md.data.dtype}")
    v = vec(Md.nshards, Md.rows_per_shard)
    ve = halo_exchange(v, Md.lo, Md.hi)
    entries["dist_spmv_ext_bf16"]["max_abs_err"] = max(
        entries["dist_spmv_ext_bf16"]["max_abs_err"],
        check_bf16(torch, "K4 bf16 on the dist solve's own partition",
                   lambda: dia_spmv_ext(Md.data, Md.offsets, ve, offsets_t=Md.offsets_t),
                   lambda: dia_spmv_ext_plain(Md.data, Md.offsets, ve)))

    # the k-rhs forms: per-column cg (DIA, K1k), bicgstab (HYB, K3k) and the
    # distributed cg (K4k), 64³, k = 4
    A = lt.sparse.laplacian_3d(64)
    AH = strayed_grid(lt, np, 64, "3d", np.float64)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal((A.shape[0], 4))).to(dev)
    cells = (("dia_spmm", "solve_ir_multi cg+ilu0 64^3", A,
              lambda: lt.solve_ir_multi(A, B, method="cg", pc="ilu0", **kw)),
             ("hyb_spmm", "solve_ir_multi gmres(30)+ilu0 64^3+strays (HYB)", AH,
              lambda: lt.solve_ir_multi(AH, B, method="gmres", pc="ilu0", **dict(
                  kw, options=dataclasses.replace(kw["options"], restart=30)))),
             ("dia_spmm_ext", "dist_solve_ir_multi cg+bjilu 64^3 P=8", A,
              lambda: lt.dist_solve_ir_multi(A, B, method="cg", pc="bjilu", mesh=mesh, **kw)))
    for kname, name, M_, run in cells:
        reset(counters)
        t0 = time.perf_counter()
        X, info = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by = bf16_launches(counters)
        routes = check_ring_routes(counters, f"bf16 {name}")
        rr = block_relres(M_, X, B, np)
        print(f"bf16 {name} k=4 [{card}]: inner its {[int(v) for v in info.nits]}, true relres "
              f"{[f'{v:.2e}' for v in rr]}, {wall:.3f} s with setup, launches {by}, "
              f"routes {routes}")
        check(max(rr) <= 1e-8, f"bf16 {name}: true relres {max(rr):.3e} > 1e-8")
        check(by.get(kname, {}).get("bf16", 0) > 0, f"bf16 {name}: {kname} never launched in bf16")
        launches[f"{kname.replace('dia_spmm_ext', 'dist_spmm_ext')}_bf16"] = by[kname]["bf16"]
        if kname == "dia_spmm":
            _, _, A32, _, _ = lt.prepare_ir(A, "cg", "ilu0", pc_options=kw["pc_options"],
                                            inner_dtype=bf, device=dev)
            V = vec(A32.shape[0], 4)
            entries["dia_spmm_bf16"]["max_abs_err"] = max(
                entries["dia_spmm_bf16"]["max_abs_err"],
                check_bf16(torch, "K1k bf16 on the multi solve's own matrix",
                           lambda: dia_spmm(A32, V), lambda: dia_spmm_plain(A32.data, A32.offsets, V)))
        if kname == "hyb_spmm":
            _, _, A32, _, _ = lt.prepare_ir(AH, "gmres", "ilu0", pc_options=kw["pc_options"],
                                            inner_dtype=bf, device=dev)
            check(isinstance(A32, lt.HYB), f"bf16 {name}: the format is {type(A32).__name__}")
            V = vec(A32.shape[0], 4)
            entries["hyb_spmm_bf16"]["max_abs_err"] = max(
                entries["hyb_spmm_bf16"]["max_abs_err"],
                check_bf16(torch, "K3k bf16 on the multi solve's own matrix",
                           lambda: hyb_spmm(A32, V), lambda: hyb_spmm_plain(A32, V)))
    for key, count in launches.items():
        entries[key]["launches"] = count
    check(all("launches" in e for e in entries.values()),
          f"phase 32: no path launched {[k for k, e in entries.items() if 'launches' not in e]}")
    print(f"phase 32 (bf16): {time.perf_counter() - t_phase:.1f} s")
    return entries


def phase_utils(lt, np, torch, dev, counters, card):
    """Phase 33: utils/.  checkpointed_solve (cg + ILU(0), 128³, fp64,
    every 50) interrupted after 2 rounds and resumed, x bitwise equal to an
    uninterrupted run's, a restored PC applying bitwise as the saved one;
    set_log's tee; the profile ledger of the run so far; the peak device
    memory; the fingerprint's time on the 128³ CSR; nan_guard."""
    import contextlib
    import io
    import tempfile
    import zlib
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv
    from lssp_tpu_torch.utils import (checkpointed_solve, device_memory_mb, load_checkpoint,
                                      nan_guard, profile, save_checkpoint, set_log)
    from lssp_tpu_torch.utils.memo import fingerprint
    t_phase = time.perf_counter()
    A = lt.sparse.laplacian_3d(128)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float64, device=dev)
    tmp = tempfile.mkdtemp(prefix="lssp_ckpt_")
    kw = dict(every=50, method="cg", pc="ilu0", device=dev)
    _, i1 = checkpointed_solve(A, b, os.path.join(tmp, "run.ckpt"), max_rounds=2, **kw)
    check(not i1.converged and i1.nits == 100,
          f"checkpoint: the interrupted run took {i1.nits} its, converged {i1.converged}")
    x2, i2 = checkpointed_solve(A, b, os.path.join(tmp, "run.ckpt"), **kw)
    x3, i3 = checkpointed_solve(A, b, os.path.join(tmp, "whole.ckpt"), **kw)
    rr = true_relres(A, x2, np)
    print(f"checkpointed_solve cg+ilu0 128^3 fp64 every 50 [{card}]: interrupted at "
          f"{i1.nits}, resumed to {i2.nits} (uninterrupted {i3.nits}), true relres {rr:.3e}, "
          f"resumed x bitwise equal: {bool(torch.equal(x2, x3))}")
    check(i2.converged and i2.nits == i3.nits and torch.equal(x2, x3),
          "checkpoint: the resumed x is not the uninterrupted one bitwise")
    M = lt.pc.setup(A, "ilu0", device=dev)
    path = os.path.join(tmp, "m.ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, x=x2, M=M, info=i2)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = load_checkpoint(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    r = torch.from_numpy(np.random.default_rng(33).uniform(-1, 1, n)).to(dev)
    check(torch.equal(ck["M"](r), M(r)) and torch.equal(ck["x"], x2),
          "checkpoint: the restored PC does not apply bitwise as the saved one")
    print(f"checkpoint file {os.path.getsize(path) / 2**20:.1f} MB (x, ILU(0) 128^3 plan, info): "
          f"save {save_s:.3f} s, load to the card {load_s:.3f} s; restored M applies bitwise")
    # set_log tees a Solver run
    buf = io.StringIO()
    s = lt.Solver("cg", "jacobi", options=lt.SolverOptions(verbosity=1), device=dev)
    s.set_log(buf)
    try:
        with contextlib.redirect_stdout(io.StringIO()):       # the tee alone is kept
            s.assemble(lt.sparse.laplacian_2d(64), torch.ones(4096, dtype=torch.float64))
            s.solve()
    finally:
        set_log(None)
    lines = buf.getvalue().splitlines()
    check(sum(l.startswith("itr:") for l in lines) == s.nits
          and any(l.startswith("pc: assemble (jacobi)") for l in lines),
          f"set_log: the tee holds {len(lines)} lines for {s.nits} iterations")
    print(f"set_log: {len(lines)} lines tee'd for a {s.nits}-iteration Solver run")
    lt.prepare_ir(A, "cg", "ilu0", device=dev)      # the ledger holds a prepare_ir at least
    times, nbytes = profile.phase_times(), profile.phase_bytes()
    print("profile phase_times (s): " + json.dumps({k: round(v, 3) for k, v in times.items()}))
    print("profile phase_bytes (MB): " + json.dumps({k: round(v / 2**20, 1)
                                                    for k, v in nbytes.items()}))
    check("pc_build" in times and "upload" in nbytes, "profile: the ledger is empty")
    print(f"device_memory_mb: {json.dumps(device_memory_mb())}")
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        fingerprint(A)
        reps.append(time.perf_counter() - t0)
    bufs = [np.ascontiguousarray(a) for a in (A.data, A.indices, A.indptr)]
    mb = sum(a.nbytes for a in bufs) / 1e6
    sums = {}
    for fn in (zlib.crc32, zlib.adler32):
        t0 = time.perf_counter()
        for a in bufs:
            fn(a)
        sums[fn.__name__] = time.perf_counter() - t0
    print(f"fingerprint of the 128^3 CSR ({mb:.0f} MB) on the card's host: median "
          f"{sorted(reps)[2] * 1e3:.1f} ms; crc32 {sums['crc32'] * 1e3:.1f} ms, adler32 "
          f"{sums['adler32'] * 1e3:.1f} ms")
    bn = torch.ones(4096, dtype=torch.float64, device=dev)
    bn[7] = float("nan")
    try:
        with nan_guard():
            lt.solve(lt.sparse.laplacian_2d(64), bn, method="cg", pc="ilu0")
        raise RuntimeError("nan_guard: a solve with a NaN in b did not raise")
    except FloatingPointError as e:
        print(f"nan_guard: {e}")
    D = lt.sparse.csr_to_dia(lt.sparse.laplacian_2d(64), device=dev)
    try:
        with nan_guard():
            dia_spmv(D, bn)
        raise RuntimeError("nan_guard: K1 on a NaN did not raise")
    except FloatingPointError as e:
        print(f"nan_guard on a kernel: {e}")
    print(f"phase 33 (utils): {time.perf_counter() - t_phase:.1f} s")


# JAX's CPU values for phase 34 (scripts/jax_krylov_reference.py tour: the
# sections of examples/tour.py and examples/distributed.py with the ILU
# PCs at 6 Neumann sweeps, the card's route): (count, true residual);
# lsq: the two relative errors
JAX_CPU_TOUR = {
    "direct": (1, 1.54e-12), "cg+arms": (5, 4.98e-07), "cg+amg": (7, 6.11e-06),
    "cg+rsamg": (7, 2.54e-07), "cg+iluk": (35, 3.02e-06), "bicg": (27, 4.64e-06),
    "qmr": (27, 3.26e-06), "cgnr": (58, 3.72e-06), "lsqr": (58, 3.72e-06), "ir": (10, 7.06e-09),
    "lsq": (3.85e-10, 553.8), "hyb": (181, None), "bf16": (130, 1.18e-07),
    "multi": ([35, 41], [3.02e-06, 5.46e-06]), "blockcg": ([32, 32], [3.45e-06, 4.54e-06]),
    "ir_multi": ([80, 50], [1.43e-11, 3.34e-09]), "ckpt_interrupted": (20, False),
    "ckpt": (37, 5.77e-06), "dist cg+bjilu": (49, 4.76e-06), "dist cg+saamg": (6, 4.12e-06),
    "dist bicgstab+bjilu": (31, 4.96e-06)}
# sections whose count is a rounding class (fp32 / bf16 inner solves,
# ROADMAP C 8-10): held to their residual bound instead of JAX's count
TOUR_ROUNDING = {"ir": 1e-7 * 64, "ir_multi": None, "bf16": 1e-8 * 64}


def phase_examples(lt, np, torch, dev, counters, card):
    """Phase 34: ``python -m lssp_tpu_torch.examples.tour`` and
    ``.distributed`` at their full sizes on the card, each section held to
    JAX's CPU count ± 2 (``JAX_CPU_TOUR``), or to its residual where the
    count is a rounding class."""
    import contextlib
    import io
    from lssp_tpu_torch.examples import distributed, tour
    t_phase = time.perf_counter()
    got = {}
    for mod in (tour, distributed):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = mod.main(["--device", str(dev)])
        print(out.getvalue().rstrip())
        print(f"examples.{mod.__name__.rsplit('.', 1)[1]} [{card}]: "
              f"{time.perf_counter() - t0:.1f} s")
        got.update(res if mod is tour else {f"dist {k}": v[:2] for k, v in res.items()})
    ns = 64
    Bn = np.linalg.norm(np.stack([np.ones(ns * ns),
                                  np.random.default_rng(0).standard_normal(ns * ns)]), axis=1)
    for cell, ref in JAX_CPU_TOUR.items():
        val = got[cell]
        if cell == "lsq":
            check(val[0] <= 1e-6, f"tour lsq: qr error {val[0]:.2e} > 1e-6")
        elif cell in TOUR_ROUNDING:
            if cell == "ir_multi":
                ok = all(r <= 1e-10 * bn * 1.1 for r, bn in zip(val[1], Bn))
            else:
                ok = val[1] <= TOUR_ROUNDING[cell]
            check(ok, f"tour {cell}: residual {val[1]} past its bound")
        elif isinstance(ref[0], list):
            check(all(abs(a - r) <= 2 for a, r in zip(val[0], ref[0])),
                  f"tour {cell}: counts {val[0]}, JAX CPU {ref[0]} ± 2")
        else:
            check(abs(val[0] - ref[0]) <= 2, f"tour {cell}: count {val[0]}, JAX CPU {ref[0]} ± 2")
    print("phase 34 examples against JAX's CPU: " + json.dumps(
        {c: [got[c][0], JAX_CPU_TOUR[c][0]] for c in JAX_CPU_TOUR if c != "lsq"}))
    print(f"phase 34 (examples): {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 35: the communicator on the card, a torch.distributed group of one
# ---------------------------------------------------------------------------

def group_cell(torch, dev, counters, solve, mesh, plain, runs):
    """``solve(mesh)`` -> (x, info) through the group and on the group-less
    mesh: the first call of each (setup included), then ``runs`` warm calls
    of each in turns, the launch counters and ``dist_ops.collectives`` reset
    before every group call and read just after it, before the group-less
    call runs.  Returns (x, info, x_plain, info_plain, first walls (group,
    plain), warm walls (group list, plain list), the last group call's
    launches and collectives by kind)."""
    from lssp_tpu_torch.parallel import dist_ops

    def timed(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve(m)
        torch.cuda.synchronize()
        return x, info, time.perf_counter() - t0

    def grouped():
        for fn in counters:
            fn.launches = 0
        dist_ops.collectives.clear()
        x, info, wall = timed(mesh)
        return (x, info, wall, {fn.__name__: fn.launches for fn in counters},
                dict(dist_ops.collectives))
    x, info, first, launches, coll = grouped()
    xp, infop, first_p = timed(plain)
    warm, warm_p = [], []
    for _ in range(runs):
        x, info, w, launches, coll = grouped()
        warm.append(w)
        xp, infop, w = timed(plain)
        warm_p.append(w)
    return x, info, xp, infop, (first, first_p), (warm, warm_p), launches, coll


def phase_comm(lt, np, torch, dev, counters, card):
    """Phase 35: the distributed path through a torch.distributed group.
    ``multihost.initialize(device="cuda")`` over a ``file://`` rendezvous of
    its own, world size 1 (NCCL), and ``global_mesh(slots=8)``; on it, each
    beside the group-less mesh of 8 slots on the card, timed in turns:
    dist_solve_ir CG + ILU(0) on 128³ (x bitwise the group-less x, the same
    inner count in [194, 262], only K4, K4 on the solve's partition and
    Neumann factors), dist_solve_ir_multi block CG + ILU(0) 64³, k = 8
    (the reduce= path: X within 1e-12 relative, the same counts, only K4k),
    and dist_solve_ir BiCGSTAB + Jacobi on a strayed 64³ DistHYB (the
    all-gather path: x bitwise, the same count).  Returns K4's max abs
    err."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from lssp_tpu_torch.parallel import DistHYB, multihost
    from lssp_tpu_torch.parallel.dist_ops import rank_sum
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "phase 35: a process group is already up")
    tmp = tempfile.mkdtemp(prefix="lssp_rdv_")
    t0 = time.perf_counter()
    multihost.initialize(f"file://{tmp}/rdv", 1, 0, device="cuda")
    init_s = time.perf_counter() - t0
    try:
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              "phase 35: initialize(device='cuda') brought up no NCCL group")
        mesh = multihost.global_mesh(slots=8)
        plain = lt.make_mesh(8, devices=[dev] * 8)
        check(mesh.group is not None and (mesh.world, mesh.size, mesh.device) == (1, 8, dev),
              f"phase 35: global_mesh gave {mesh}")
        # NCCL builds its communicator at the first collective
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = rank_sum(torch.ones(1, device=dev), mesh)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0
        check(one.item() == 1.0, "phase 35: a sum over one rank is not the value")
        print(f"phase 35 [{card}]: process group nccl, world {mesh.world}, rendezvous "
              f"{init_s:.3f} s, NCCL's first collective (communicator start) {nccl_s:.3f} s")
        opts = lt.SolverOptions(rtol=1e-8, atol=0, maxit=5000)

        # the main path: dist_solve_ir cg + ILU(0) 128^3 over 8 shards
        A = lt.sparse.laplacian_3d(128)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)

        def main_solve(m):
            return lt.dist_solve_ir(A, b, method="cg", pc="ilu0", mesh=m, options=opts)
        x, info, xp, infop, first, warm, launches, coll = group_cell(
            torch, dev, counters, main_solve, mesh, plain, runs=5)
        rr = true_relres(A, x, np)
        ncoll = sum(coll.values())
        print(f"comm 128^3 dist_solve_ir cg+ilu0 [{card}]: inner its {info.nits} (group-less "
              f"{infop.nits}), true relres {rr:.3e}, x bitwise the group-less x: "
              f"{bool(torch.equal(x, xp))}; first call {first[0]:.3f} s (group-less "
              f"{first[1]:.3f} s); warm through the group {', '.join(f'{w:.3f}' for w in warm[0])}"
              f" s, group-less {', '.join(f'{w:.3f}' for w in warm[1])} s; collectives a call "
              f"{coll} ({ncoll / info.nits:.2f} an inner iteration); launches {launches}")
        check(torch.equal(x, xp), "comm 128^3: x differs from the group-less mesh's x")
        check(info.nits == infop.nits and 194 <= info.nits <= 262,
              f"comm 128^3: inner its {info.nits} (group-less {infop.nits}) outside [194, 262]")
        check(rr <= 1e-8, f"comm 128^3: true relres {rr:.3e} > 1e-8")
        check(coll.get("all_gather", 0) >= info.nits, f"comm 128^3: collectives {coll}")
        check_only_k4(launches, "comm 128^3")
        print("comm 128^3 through the group: " + profiled(
            torch, lambda: main_solve(mesh), info.nits, "dia_spmv_ext_kernel"))
        preps = {key[0]: prep for key, prep in A._dist_cache.items()}
        abs_err, _, _ = check_dist_path(lt, np, torch, dev, preps[mesh], "comm 128^3")
        del A, b, x, xp, preps

        # the reduce= path: block CG k = 8 on 64^3
        A = lt.sparse.laplacian_3d(64)
        B = serving_block(np, torch, dev, A.shape[0])

        def block_solve(m):
            return lt.dist_solve_ir_multi(A, B, method="blockcg", pc="ilu0", mesh=m,
                                          options=opts)
        X, info, Xp, infop, first, warm, launches, coll = group_cell(
            torch, dev, counters, block_solve, mesh, plain, runs=1)
        dx = float((X - Xp).norm() / Xp.norm())
        rr = block_relres(A, X, B, np)
        print(f"comm 64^3 dist_solve_ir_multi blockcg+ilu0 k=8 [{card}]: inner its "
              f"{info.nits.tolist()} (group-less {infop.nits.tolist()}), X against the group-less X "
              f"{dx:.3e} relative, true relres max {max(rr):.3e}; first {first[0]:.3f} s "
              f"(group-less {first[1]:.3f} s), warm {', '.join(f'{w:.3f}' for w in warm[0])} s "
              f"(group-less {', '.join(f'{w:.3f}' for w in warm[1])} s); collectives a call "
              f"{coll}; launches {launches}")
        check(dx <= 1e-12 and np.array_equal(info.nits, infop.nits),
              f"comm blockcg: X {dx:.3e} from the group-less X, its {info.nits} / {infop.nits}")
        check(max(rr) <= 1e-8, f"comm blockcg: true relres {max(rr):.3e}")
        check_only(launches, {"dia_spmm_ext"}, "comm blockcg")

        # the all-gather path: BiCGSTAB + Jacobi on a strayed 64^3 DistHYB
        A = strayed_grid(lt, np, 64, "3d", np.float64)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)

        def hyb_solve(m):
            return lt.dist_solve_ir(A, b, method="bicgstab", pc="jacobi", mesh=m, options=opts)
        x, info, xp, infop, first, warm, launches, coll = group_cell(
            torch, dev, counters, hyb_solve, mesh, plain, runs=1)
        rr = true_relres(A, x, np)
        preps = {key[0]: prep for key, prep in A._dist_cache.items()}
        print(f"comm 64^3+strays dist_solve_ir bicgstab+jacobi [{card}]: inner its {info.nits} "
              f"(group-less {infop.nits}), true relres {rr:.3e}, x bitwise the group-less x: "
              f"{bool(torch.equal(x, xp))}; warm {', '.join(f'{w:.3f}' for w in warm[0])} s "
              f"(group-less {', '.join(f'{w:.3f}' for w in warm[1])} s); collectives a call "
              f"{coll}; launches {launches}")
        check(isinstance(preps[mesh]["M"], DistHYB), "comm hyb: the partition is not DistHYB")
        check(torch.equal(x, xp) and info.nits == infop.nits,
              f"comm hyb: x or its count {info.nits} differs from the group-less {infop.nits}")
        check(rr <= 1e-8, f"comm hyb: true relres {rr:.3e} > 1e-8")
        check_only_k4(launches, "comm hyb")
        print("phase 35: a world size above 1 needs more than one card; W = 2 and 4 gloo ranks "
              "are held on the CPU (tests/test_torch_dist_ranks.py), bitwise to this one-process "
              "mesh")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 35 (communicator): {time.perf_counter() - t_phase:.1f} s")
    return abs_err


# ---------------------------------------------------------------------------
# phase 36: the distributed AMG through a torch.distributed group of one
# ---------------------------------------------------------------------------

def report_group_cell(np, name, card, nits, nits_p, first, warm, launches, coll, extra=""):
    """One line of phase 36: the counts both ways, the kernel launches, the
    collectives of the group call by kind, a call and an inner iteration,
    and the first and warm walls both ways."""
    its = int(np.max(nits))
    per_it = {k: round(v / max(its, 1), 2) for k, v in coll.items()}
    print(f"{name} [{card}]: inner its {nits} (group-less {nits_p}){extra}; K4 / K4k launches "
          f"{launches['dia_spmv_ext']} / {launches['dia_spmm_ext']}, all launches {launches}; "
          f"collectives a call {coll}, an inner iteration {per_it}; first call {first[0]:.3f} s "
          f"(group-less {first[1]:.3f} s); warm through the group "
          f"{', '.join(f'{w:.3f}' for w in warm[0])} s, group-less "
          f"{', '.join(f'{w:.3f}' for w in warm[1])} s")


def phase_amg_group(lt, np, torch, dev, counters, card):
    """Phase 36: the distributed AMG through a torch.distributed group.
    ``multihost.initialize(device="cuda")`` over a ``file://`` rendezvous of
    its own, world size 1 (NCCL), and ``global_mesh(slots=8)``; on it, each
    beside the group-less mesh of 8 slots on the card, timed in turns
    (``group_cell``): (a) dist_solve_ir GMRES(30) + saamg on the anisotropic
    1024² (ε 0.01, phase 27's cell), (b) the same at 256² with the line
    smoother (the Spike interface gather), (c) dist_solve_ir CG + rsamg on
    64³, (d) dist_solve GMRES(30) + classical amg fp64 on the anisotropic
    512² (ε 1e-3, phase 27's), x bitwise the group-less x and the same
    count in (a)-(d); (e) dist_solve_ir_multi block CG + saamg 512², k = 8,
    X within 1e-12 relative and the same counts.  (a), (c) and (e) launch
    only K4 (K4k), and K4 is checked on level 0 of each of their
    hierarchies.  Returns K4's max abs err."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from lssp_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "phase 36: a process group is already up")
    tmp = tempfile.mkdtemp(prefix="lssp_rdv36_")
    multihost.initialize(f"file://{tmp}/rdv", 1, 0, device="cuda")
    k4_err = 0.0
    try:
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              "phase 36: initialize(device='cuda') brought up no NCCL group")
        mesh = multihost.global_mesh(slots=8)
        plain = lt.make_mesh(8, devices=[dev] * 8)
        check(mesh.group is not None and (mesh.world, mesh.size) == (1, 8),
              f"phase 36: global_mesh gave {mesh}")
        opts = lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
        gmres = dataclasses.replace(opts, restart=30)

        def k4_on_level0(A, name):
            preps = {key[0]: prep for key, prep in A._dist_cache.items()}
            h = preps[mesh]["pc_state"]
            return check_dist_levels(np, torch, dev, h.levels[:1], name)[0]

        def vector_cell(name, A, solve, only_k4, runs=1):
            nonlocal k4_err
            x, info, xp, infop, first, warm, launches, coll = group_cell(
                torch, dev, counters, solve, mesh, plain, runs=runs)
            rr = true_relres(A, x, np)
            report_group_cell(np, name, card, info.nits, infop.nits, first, warm, launches, coll,
                              f", true relres {rr:.3e}, x bitwise the group-less x: "
                              f"{bool(torch.equal(x, xp))}")
            check(torch.equal(x, xp) and info.nits == infop.nits,
                  f"{name}: x or its count {info.nits} differs from the group-less "
                  f"{infop.nits}")
            check(rr <= 1e-8, f"{name}: true relres {rr:.3e} > 1e-8")
            check(coll.get("all_gather", 0) > info.nits, f"{name}: collectives {coll}")
            if only_k4:
                check_only_k4(launches, name)
                check(launches["dia_spmm_ext"] == 0, f"{name}: K4k launched on a vector")
                k4_err = max(k4_err, k4_on_level0(A, name))

        # (a) phase 27's full-width saamg cell
        A = lt.sparse.anisotropic_poisson_2d(1024, epsilon=0.01)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
        vector_cell("amg group (a) aniso 1024^2 dist_solve_ir gmres(30)+saamg", A,
                    lambda m: lt.dist_solve_ir(A, b, method="gmres", pc="saamg", mesh=m,
                                               options=gmres), True)
        # (b) the line smoother: the Spike interface all-gather (256²: at 512²
        # its plain-torch PCR took 11 s of the phase, the cell checks the same)
        A = lt.sparse.anisotropic_poisson_2d(256, epsilon=0.01)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
        line = lt.PCOptions(amg_smoother="line")
        vector_cell("amg group (b) aniso 256^2 dist_solve_ir gmres(30)+saamg line", A,
                    lambda m: lt.dist_solve_ir(A, b, method="gmres", pc="saamg", mesh=m,
                                               options=gmres, pc_options=line), False)
        # (c) rsamg
        A = lt.sparse.laplacian_3d(64)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
        vector_cell("amg group (c) 64^3 dist_solve_ir cg+rsamg", A,
                    lambda m: lt.dist_solve_ir(A, b, method="cg", pc="rsamg", mesh=m,
                                               options=opts), True)
        # (d) classical amg, fp64: every level product gathers its vector
        A = lt.sparse.anisotropic_poisson_2d(512)
        b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
        o = dataclasses.replace(gmres, maxit=5000)
        vector_cell("amg group (d) aniso 512^2 eps 1e-3 dist_solve gmres(30)+amg fp64", A,
                    lambda m: lt.dist_solve(A, b, method="gmres", pc="amg", mesh=m, options=o),
                    False)
        # (e) block CG + saamg, k = 8
        name = "amg group (e) aniso 512^2 dist_solve_ir_multi blockcg+saamg k=8"
        A = lt.sparse.anisotropic_poisson_2d(512, epsilon=0.01)
        B = serving_block(np, torch, dev, A.shape[0])
        X, info, Xp, infop, first, warm, launches, coll = group_cell(
            torch, dev, counters,
            lambda m: lt.dist_solve_ir_multi(A, B, method="blockcg", pc="saamg", mesh=m,
                                             options=opts), mesh, plain, runs=1)
        dx = float((X - Xp).norm() / Xp.norm())
        rr = block_relres(A, X, B, np)
        report_group_cell(np, name, card, info.nits.tolist(), infop.nits.tolist(), first, warm,
                          launches, coll, f", X against the group-less X {dx:.3e} relative, "
                          f"true relres max {max(rr):.3e}")
        check(dx <= 1e-12 and np.array_equal(info.nits, infop.nits),
              f"{name}: X {dx:.3e} from the group-less X, its {info.nits} / {infop.nits}")
        check(max(rr) <= 1e-8, f"{name}: true relres {max(rr):.3e}")
        check_only(launches, {"dia_spmm_ext"}, name)
        k4_err = max(k4_err, k4_on_level0(A, name))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 36 (distributed AMG through the group): {time.perf_counter() - t_phase:.1f} s")
    return k4_err


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "lssp_tpu_torch")):
        raise SystemExit(f"chip_smoke: no lssp_tpu_torch package beside {HERE}; run the script "
                         "from a checkout of the repo")
    import numpy as np
    import lssp_tpu_torch as lt
    from lssp_tpu_torch import _kernels
    from lssp_tpu_torch.ops.dia_spmv import dia_spmv
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmv_ext
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmv
    from lssp_tpu_torch.ops.neumann import fused_neumann_apply, neumann_block_apply
    from lssp_tpu_torch.ops.dia_spmv import dia_spmm
    from lssp_tpu_torch.ops.dia_spmv_ext import dia_spmm_ext
    from lssp_tpu_torch.ops.hyb_spmv import hyb_spmm
    check(os.path.dirname(os.path.abspath(lt.__file__)) == os.path.join(HERE, "lssp_tpu_torch"),
          f"lssp_tpu_torch was imported from {lt.__file__}, not from this checkout")
    dev = torch.device("cuda:0")
    card = stack(_kernels)
    if "--only" in sys.argv:
        # a development run of the named phases of this slice alone: it prints
        # no kernel line and no result line
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext, dia_spmm,
                    neumann_block_apply, hyb_spmm, dia_spmm_ext)
        for phase, fn in (("28", phase_transpose), ("29", phase_relax), ("30", phase_direct),
                          ("31", phase_ilutp_arms_ca), ("32", phase_bf16), ("33", phase_utils),
                          ("34", phase_examples), ("35", phase_comm), ("36", phase_amg_group)):
            if phase in only:
                print(json.dumps({f"phase {phase} max_abs_err": fn(lt, np, torch, dev, counters,
                                                                    card)}))
        print(f"chip_smoke: ran phases {only} alone; no result line")
        return
    k1 = phase_k1(lt, np, torch, dev)
    k2 = phase_k2(lt, np, torch, dev)
    launches = phase_main(lt, np, torch, dev, (dia_spmv, fused_neumann_apply))
    phase_128(lt, np, torch, dev)
    phase_exam(lt, np, torch, dev)
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv)
    phase_k3(lt, np, torch, dev, card)
    hyb_launches, k3 = phase_hyb_main(lt, np, torch, dev, counters, card)
    phase_acceptance(lt, np, torch, dev, counters, card, "coupled3d_25", "bicgstab", "iluk",
                     None, 22, "HYB")
    phase_acceptance(lt, np, torch, dev, counters, card, "convdiff_rot_128", "gmres", "ilut",
                     30, 191, "DIA")
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext)
    phase_k4(lt, np, torch, dev, card)
    dist_launches, k4 = phase_dist_main(lt, np, torch, dev, counters, card)
    phase_dist_hyb(lt, np, torch, dev, counters, card)
    krhs = phase_krhs(lt, np, torch, dev, card)
    counters = (dia_spmv, fused_neumann_apply, hyb_spmv, dia_spmv_ext, dia_spmm,
                neumann_block_apply, hyb_spmm, dia_spmm_ext)
    serving_launches, serving_errs = phase_serving(lt, np, torch, dev, counters, card)
    per_column_errs = phase_per_column(lt, np, torch, dev, counters)
    hyb_multi_launches, hyb_multi_errs = phase_hyb_multi(lt, np, torch, dev, counters, card)
    dist_multi_launches, k4k_err = phase_dist_multi(lt, np, torch, dev, counters, card)
    _, saamg_errs, saamg_nits = phase_saamg_main(lt, np, torch, dev, counters, card)
    _, classical_errs = phase_amg_classical(lt, np, torch, dev, counters, card)
    rsamg_errs, rsamg_nits = phase_rsamg(lt, np, torch, dev, counters, card)
    _, block_err = phase_saamg_block(lt, np, torch, dev, counters, card)
    krylov_errs = [
        phase_krylov(lt, np, torch, dev, counters, card, 23, lt.sparse.laplacian_3d(128),
                     "krylov 128^3", KRYLOV),
        phase_krylov(lt, np, torch, dev, counters, card, 24,
                     lt.sparse.convection_diffusion_2d(1024), "krylov convdiff 1024^2",
                     [m for m in KRYLOV if m != "minres"])]
    krylov_block_errs = phase_krylov_per_column(lt, np, torch, dev, counters)
    _, block_k1_err = phase_block(lt, np, torch, dev, counters, card)
    dist_amg = phase_dist_amg(lt, np, torch, dev, counters, card, saamg_nits, rsamg_nits)
    transpose_errs = phase_transpose(lt, np, torch, dev, counters, card)
    relax_errs = phase_relax(lt, np, torch, dev, counters, card)
    direct_errs = phase_direct(lt, np, torch, dev, counters, card)
    ca_errs = phase_ilutp_arms_ca(lt, np, torch, dev, counters, card)
    bf16 = phase_bf16(lt, np, torch, dev, counters, card)
    phase_utils(lt, np, torch, dev, counters, card)
    phase_examples(lt, np, torch, dev, counters, card)
    comm_err = phase_comm(lt, np, torch, dev, counters, card)
    amg_group_err = phase_amg_group(lt, np, torch, dev, counters, card)
    library = phase_library(lt, np, torch, dev, card)
    # each kernel's error is the worst over its own phase and the later
    # phases' checks on their own data
    for errs in (serving_errs, per_column_errs, hyb_multi_errs, {"dist_spmm_ext": k4k_err},
                 {"dia_spmm": block_err}, krylov_block_errs):
        for kname, err in errs.items():
            krhs[kname]["max_abs_err"] = max(krhs[kname]["max_abs_err"], err)
    k1["max_abs_err"] = max(k1["max_abs_err"], block_k1_err, relax_errs["dia_spmv"],
                            direct_errs["dia_spmv"])
    k2["max_abs_err"] = max(k2["max_abs_err"], transpose_errs["neumann_sweep"],
                            relax_errs["neumann_sweep"], ca_errs["neumann_sweep"])
    k3["max_abs_err"] = max(k3["max_abs_err"], transpose_errs["hyb_spmv"],
                            direct_errs["hyb_spmv"])
    krhs["neumann_sweep_block"]["max_abs_err"] = max(
        krhs["neumann_sweep_block"]["max_abs_err"], transpose_errs["neumann_sweep_block"])
    k4["max_abs_err"] = max(k4["max_abs_err"], dist_amg["saamg"], dist_amg["rsamg"],
                            ca_errs["dist_spmv_ext"], comm_err, amg_group_err)
    for errs in (saamg_errs, classical_errs, rsamg_errs, *krylov_errs):
        k1["max_abs_err"] = max(k1["max_abs_err"], errs.get("dia_spmv", 0.0))
        k2["max_abs_err"] = max(k2["max_abs_err"], errs.get("neumann_sweep", 0.0))
        k3["max_abs_err"] = max(k3["max_abs_err"], errs.get("hyb_spmv", 0.0))
    kernels = [
        dict(name="dia_spmv", route="cuda", source="lssp_tpu_torch/csrc/dia_spmv.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:91", launches=launches["dia_spmv"], **k1),
        dict(name="neumann_sweep", route="cuda", source="lssp_tpu_torch/csrc/neumann.cu",
             replaces="lssp_tpu/ops/pallas_neumann.py:196",
             launches=launches["fused_neumann_apply"], **k2),
        dict(name="hyb_spmv", route="cuda", source="lssp_tpu_torch/csrc/hyb_spmv.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:370, lssp_tpu/ops/pallas_spmv.py:218",
             launches=hyb_launches["hyb_spmv"], **k3),
        dict(name="dist_spmv_ext", route="cuda", source="lssp_tpu_torch/csrc/dia_spmv_ext.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:91 (prepadded=True), :710",
             launches=dist_launches["dia_spmv_ext"], **k4),
        dict(name="dia_spmm", route="cuda", source="lssp_tpu_torch/csrc/dia_spmv.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:91 (k-rhs vmap rule :648)",
             launches=serving_launches["dia_spmm"], **krhs["dia_spmm"]),
        dict(name="neumann_sweep_block", route="cuda", source="lssp_tpu_torch/csrc/neumann.cu",
             replaces="lssp_tpu/ops/pallas_neumann.py:196 (k-rhs vmap rule :280)",
             launches=serving_launches["neumann_block_apply"], **krhs["neumann_sweep_block"]),
        dict(name="hyb_spmm", route="cuda", source="lssp_tpu_torch/csrc/hyb_spmv.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:370 (k-rhs vmap rule :534), "
                      "lssp_tpu/ops/pallas_spmv.py:218 (k-rhs vmap rule :588)",
             launches=hyb_multi_launches["hyb_spmm"], **krhs["hyb_spmm"]),
        dict(name="dist_spmm_ext", route="cuda", source="lssp_tpu_torch/csrc/dia_spmv_ext.cu",
             replaces="lssp_tpu/ops/pallas_spmv.py:91 (prepadded=True; k-rhs vmap rule :691)",
             launches=dist_multi_launches["dia_spmm_ext"], **krhs["dist_spmm_ext"]),
    ]
    for entry in kernels:
        entry.update(library[entry["name"]])
    # the bf16 forms (phase 32): times, library and bound at their own shapes
    for entry in list(kernels):
        e = bf16.get(entry["name"] + "_bf16")
        if e is not None:
            kernels.append({**dict(name=entry["name"] + "_bf16", route=entry["route"],
                                   source=entry["source"],
                                   replaces=entry["replaces"] + " (bf16)"), **e})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
