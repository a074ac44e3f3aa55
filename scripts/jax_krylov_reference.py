#!/usr/bin/env python3
"""Iteration counts for the Krylov phases of ``chip_smoke.py`` (23, 24 and
28-31): the JAX package's on the CPU, the reference the port's counts on
the card are held to, and with ``--port`` the port's own.

    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--ulp|--ulp32]
                                                              [23|24] [method ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--ulp32]
                                                              28|28cd|28tall|28hyb|28dist|29
                                                              [cell ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--ulp32]
                                                              30|31 [cell ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] 32 [method ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--exact] tour
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py --shadow
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py --ratchet-ulp [--part i/k] [key ...]

Phase 23 solves the 3-D Laplacian 128³ and phase 24 the convection-
diffusion 1024² (beta 20), both with b = 1, through ``solve_ir`` (fp32
inner, fp64 outer) with ILU(0) applied by 6 Neumann sweeps (the card's
default, pinned here because the CPU default is the exact solve), rtol
1e-8, atol 0, rbtol 0, for each of the general Krylov methods (phase 24
without minres, which needs a symmetric A).  Each solve prints one JSON
line: the package, the phase, the method, the total inner iterations,
whether it converged and the true relative residual recomputed with
scipy.  A method takes about 10-40 s for JAX at 128³ and 30-330 s at
1024².  The port runs on ``--device`` (default cpu; ``cuda`` on a card,
where this script needs no JAX).

``--ulp`` solves each system three more times, each with three entries
of b raised by one ulp, and prints the three (count, converged) pairs: a
count that moves under such changes moves with rounding alone.  An fp64
ulp of b mostly vanishes in the fp32 cast of the inner right-hand side;
``--ulp32`` raises the three entries by one fp32 ulp (1 + 2⁻²³) instead,
a change of b that the fp32 inner solves see.

The transpose and relaxation cells (``chip_smoke.py`` phases 28-29), each
one JSON line with its count, whether it converged and the true relative
residual (scipy):

- ``28``: ``solve_ir`` + ILU(0) (6 sweeps; the transpose methods build the
  M⁻ᵀ apply), rtol 1e-8, on the 3-D Laplacian 128³ for bicg, qmr, cgnr and
  lsqr, cgnr and lsqr with the port's inner cap (``normal_equation_inner_cap``;
  ``--jax-cap`` keeps JAX's, under which cgnr stops unconverged at 4,000
  inner iterations after 12 min);
- ``28cd``: bicg and qmr on the convection-diffusion 1024² (beta 20);
- ``28tall``: ``solve`` lsqr, fp64, no PC, rtol 1e-8, on the Tikhonov
  least-squares system [L; 0.1·I], L = ``laplacian_2d(1024)`` (2,097,152
  × 1,048,576), b = A·1; JAX runs it through an ELL container, since its
  own HYB route fails (``28hyb``); the line also gives ‖Aᵀ(b − Ax)‖ /
  ‖Aᵀb‖;
- ``28hyb``: JAX's own route for the same system at 128², which converts
  it to HYB and fails in ``spmv_t`` (its DIA/HYB transpose product sizes
  its output by the row count): the line records the error;
- ``28dist``: ``dist_solve_ir`` bicg + bjilu and qmr + jacobi on 128³ over
  an 8-slot mesh (8 virtual CPU devices for JAX), 6 sweeps;
- ``29``: ``solve_ir`` (6 sweeps) on 128³ with the relaxation, polynomial
  and Schwarz preconditioners: cg + ssor, poly and chebyshev; gmres(30) +
  sor (ω 1.3), gs, ras, schwarz and bjacobi (512 blocks, overlap 8);
  bicg + ssor and qmr + poly.  JAX's relaxation factors are kept in the
  matrix's dtype (``relax_in_matrix_dtype``).

Cells are named as ``chip_smoke.py`` prints them (``cgnr``, ``gmres30+ras``,
``dist bicg+bjilu``, ...).  ``--ulp32`` gives a solve_ir cell's spread as
for phases 23-24.

The direct-solver cells (``chip_smoke.py`` phases 30-31), one JSON line each:

- ``30``: the host factors of the direct cells, which JAX computes at any
  size: ``splu_factor`` (AMD, ``method="auto"``: the multifrontal engine)
  of the 2-D Laplacian 512², the vendored coupled3d_25 and
  convdiff_rot_128, and of AᵀA for the tall [L; 0.1·I], L =
  ``laplacian_2d(256)`` (``solve_lsq``'s normal route): the factor
  seconds, nnz, and for each factor JAX's padded level schedule (nlev,
  widest level w, longest row k, nlev·w·k slots) beside the sum over the
  levels of each level's own width times row length; then ``solve_lsq``
  (qr route, m·n > 2e7: sparse Givens QR) on the tall system, b = A·1:
  ‖Aᵀ(b − Ax)‖ / ‖Aᵀb‖ and x's distance from ``spsolve(AᵀA, Aᵀb)``.  JAX's
  own ``direct`` cannot run at these sizes (its padded schedules would
  need ``slots`` × 12 bytes); the card's solves are held to scipy;
- ``31``: ``solve_ir`` gmres(30) + ilutp (6 sweeps) on coupled3d_25 and the
  convection-diffusion 256² (β 20), with the columns the pivoting moved;
  the tiny-diagonal pivot system (n = 128, ``tests/test_ilu.py``) through
  ``solve`` gmres fp64 with 6 sweeps and exact; ``solve_ir`` gmres(30) +
  arms on the convection-diffusion 256² and the anisotropic Poisson 256²
  (ε 0.01), with the level count and the coarse n (and at 128², the size
  an ARMS cell falls back to when its coarse chain is too slow); ``solve_ir`` + ILU(0)
  (6 sweeps) on 128³ with cg, pipecg, gmres(30) and cagmres(30); and
  ``dist_solve_ir`` pipecg + bjilu on 128³ over 8 shards.

``32``: ``solve_ir`` with the bf16 inner solve (``run_bf16``): cg + ILU(0)
on 64³, and bicgstab / gmres / cg + ILU(0) on the strayed 64³; ~5 s to
~3 min a cell for JAX.

``tour``: every section of ``examples/tour.py`` and
``examples/distributed.py`` (``tour_cells``; the sizes of
``lssp_tpu_torch/examples/tour.py``), one JSON line each, with the
ILU-family PCs at 6 Neumann sweeps, the card's route (``--exact``: the
CPU default, the exact solve); about 1 min for JAX.

``--ratchet-ulp`` goes through the ``tests/golden/ratchet.json`` keys the
port holds (N = 32 and N = 100 on the 2-D Laplacian, b = 1, restart 60,
maxit 2000 / 3000, ILU exact, ``biluk`` with ``num_blocks`` = n/4, as
``tests/test_solvers.py: run_config`` runs them) and prints for each the
port's count on the CPU, JAX's counts under b = 1 and under three 1-ulp
changes of b (``ulp_rhs``: three entries set to ``nextafter(1, 2)``,
seeds 1-3), the ratchet limit (recorded + max(2, 5 %)) and whether JAX's
own maximum passes it.  ``--part i/k`` runs every k-th key from the i-th
(for k processes side by side); a key named on the command line runs
alone.  About 20 min for all keys in one process.

``--jax-shadow`` (with ``--port``) gives the port's IDR(s) JAX's own
shadow space, built by ``lssp_tpu/solvers/idrs.py:37-44`` with its fp32
``jnp.dot``, in place of the port's (the two differ by property 7 of
ROADMAP queue C): whether that space alone moves the port's fp32 count.

``--shadow`` prints, in fp32 at n = 2,097,152 (128³), the relative error
of JAX's ``jnp.dot`` and ``jnp.sum(a * b)`` and of ``torch.dot`` against
an fp64 sum, and how far IDR(s)'s shadow space after MGS is from
orthonormal in each package (``lssp_tpu/solvers/idrs.py:37-44`` orthogonalizes
with ``jnp.dot``).
"""
import importlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import lssp_tpu_torch as T  # noqa: E402

PORT = "--port" in sys.argv
DEVICE = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cpu"
METHODS = ["cgs", "cr", "crs", "bicrstab", "bicgsafe", "bicrsafe", "gpbicg", "gpbicr",
           "qmrcgstab", "tfqmr", "orthomin", "bicgstabl", "idrs", "lgmres", "rlgmres",
           "minres", "fgmres"]


def jax_package():
    if ("28dist" in sys.argv or "31" in sys.argv or "tour" in sys.argv) and "xla_force_host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import lssp_tpu
    if "29" in sys.argv:
        relax_in_matrix_dtype()
    if "28" in sys.argv:
        normal_equation_inner_cap()
    return jax, lssp_tpu


def normal_equation_inner_cap():
    """JAX's ``_inner_plan`` caps every non-GMRES inner solve at 200
    iterations; cgnr and lsqr then restart their Krylov space each round and
    at 128³ + ILU(0) end at relres 1.6e-2 after 20 rounds (4,000 inner
    iterations).  The port gives them the whole maxit
    (``lssp_tpu_torch/solvers/refine.py: _inner_plan``); for phase 28's
    counts JAX's plan does too here, in this process only (``--jax-cap``
    keeps JAX's own)."""
    if "--jax-cap" in sys.argv:
        return
    import dataclasses
    from lssp_tpu.solvers import refine
    plan = refine._inner_plan

    def patched(method, opts, inner_rtol):
        fn, inner_opts = plan(method, opts, inner_rtol)
        if method.lower() in ("cgnr", "cgn", "lsqr"):
            inner_opts = dataclasses.replace(inner_opts, maxit=opts.maxit)
        return fn, inner_opts
    refine._inner_plan = patched


def relax_in_matrix_dtype():
    """JAX's ssor / sor / gs factors of a float32 matrix come out float64
    (``lssp_tpu/pc/relax.py: _safe_diag`` promotes the diagonal), and its
    fp32 ``solve_ir`` then stops with a dtype error in the inner loop
    (ROADMAP C property 12).  For the phase 29 counts the clamp keeps the
    diagonal's dtype here, in this process only, as the port does."""
    from lssp_tpu.pc import relax
    safe = relax._safe_diag
    relax._safe_diag = lambda d: safe(d).astype(np.asarray(d).dtype)


def jax_shadow(s, n, dtype):
    """IDR(s)'s shadow space as JAX builds it, MGS with ``jnp.dot``."""
    jax, _ = jax_package()
    import jax.numpy as jnp
    P = jax.random.uniform(jax.random.PRNGKey(0), (s, n), dtype=getattr(jnp, dtype))

    def orth(j, P):                         # lssp_tpu/solvers/idrs.py:37-44
        pj = P[j] / jnp.sqrt(jnp.dot(P[j], P[j]))
        P = P.at[j].set(pj)
        return jax.lax.fori_loop(0, s, lambda i, P: jax.lax.cond(
            i > j, lambda P: P.at[i].set(P[i] - jnp.dot(pj, P[i]) * pj), lambda P: P, P), P)
    return np.asarray(jax.lax.fori_loop(0, s, orth, P))


def shadow():
    """fp32 reduction accuracy and the orthonormality of both shadow spaces."""
    jax, _ = jax_package()
    import jax.numpy as jnp
    from lssp_tpu_torch.solvers.idrs import shadow_space
    n, s = 128 ** 3, 4
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    out = {"jnp.dot": float(jax.jit(jnp.dot)(a, b)),
           "jnp.sum(a*b)": float(jax.jit(lambda x, y: jnp.sum(x * y))(a, b)),
           "torch.dot": float(torch.dot(torch.from_numpy(a), torch.from_numpy(b)))}
    print(json.dumps({"n": n, "fp32 relative error": {k: abs(v - exact) / exact
                                                      for k, v in out.items()}}))
    Pj = jax_shadow(s, n, "float32").astype(np.float64)
    Pt = shadow_space(s, n, torch.float32, "cpu").numpy().astype(np.float64)
    print(json.dumps({"n": n, "s": s, "max |P P^T - I|": {
        "lssp_tpu": float(np.abs(Pj @ Pj.T - np.eye(s)).max()),
        "lssp_tpu_torch": float(np.abs(Pt @ Pt.T - np.eye(s)).max())},
        "max |P_jax - P_torch|": float(np.abs(Pj - Pt).max())}))


def ulp_rhs(n, seed):
    """b = 1 with three entries one ulp up (seed None: b = 1)."""
    b = np.ones(n)
    if seed is not None:
        b[np.random.default_rng(seed).integers(0, n, 3)] = np.nextafter(1.0, 2.0)
    return b


def ratchet_limit(recorded):
    """``tests/golden/ratchet.json``'s holding rule: recorded + max(2, 5 %)."""
    return recorded + max(2, int(np.ceil(0.05 * recorded)))


def ratchet_keys():
    """The ratchet keys on the 2-D Laplacian whose method and PC the port has."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "golden", "ratchet.json")
    with open(path) as f:
        rec = json.load(f)
    keys = []
    for key in sorted(rec):
        mp, size = key.split("@")
        method, pc = mp.split("+")
        if size in ("32", "100") and method in T.solvers.SOLVERS \
                and pc in T.pc.PC_REGISTRY:
            keys.append((key, method, pc, int(size), rec[key]))
    return keys


def ratchet_ulp():
    jax, J = jax_package()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    part = sys.argv[sys.argv.index("--part") + 1] if "--part" in sys.argv else "0/1"
    i, k = (int(v) for v in part.split("/"))
    named = [a for a in args if "@" in a]
    keys = [t for t in ratchet_keys() if t[0] in named] if named else ratchet_keys()[i::k]
    for key, method, pc, N, recorded in keys:
        n = N * N
        maxit = 2000 if N == 32 else 3000
        counts = []
        for M in (T, J):
            pco = M.PCOptions(ilu_sweeps=0, num_blocks=n // 4 if pc == "biluk" else None)
            for seed in ([None] if M is T else [None, 1, 2, 3]):
                b = ulp_rhs(n, seed)
                b = torch.from_numpy(b) if M is T else jax.numpy.asarray(b)
                _, info = M.solve(M.sparse.laplacian_2d(N), b, method=method, pc=pc,
                                  options=M.SolverOptions(restart=60, maxit=maxit),
                                  pc_options=pco)
                counts.append(int(info.nits))
        lim = ratchet_limit(recorded)
        print(json.dumps(dict(key=key, port=counts[0], jax=counts[1:], limit=lim,
                              jax_max_over_limit=max(counts[1:]) > lim)), flush=True)


IR_OPTS = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
# chip_smoke.py phase 29: (cell, method, pc, restart, extra PCOptions)
RELAX_CELLS = [("cg+ssor", "cg", "ssor", None, {}), ("cg+poly", "cg", "poly", None, {}),
               ("cg+chebyshev", "cg", "chebyshev", None, {}),
               ("gmres30+sor", "gmres", "sor", 30, {"omega": 1.3}),
               ("gmres30+gs", "gmres", "gs", 30, {}), ("gmres30+ras", "gmres", "ras", 30, {}),
               ("gmres30+schwarz", "gmres", "schwarz", 30, {}),
               ("gmres30+bjacobi", "gmres", "bjacobi", 30, {}),
               ("bicg+ssor", "bicg", "ssor", None, {}), ("qmr+poly", "qmr", "poly", None, {})]


def tall_system(M, N):
    """[L; 0.1·I] with L = laplacian_2d(N), in package M's CSR."""
    import scipy.sparse as sp
    L = M.sparse.laplacian_2d(N).to_scipy()
    S = sp.vstack([L, 0.1 * sp.eye(L.shape[0], format="csr")]).tocsr()
    S.sort_indices()
    return M.sparse.CSR.from_scipy(S)


def ir_cell(M, kw, A, method, pc, restart=None, **pco):
    """A solve_ir cell: b ↦ (x, info)."""
    opts = M.SolverOptions(**IR_OPTS, **({"restart": restart} if restart else {}))
    pco = M.PCOptions(ilu_sweeps=6, **pco)
    return lambda b: M.solve_ir(A, b, method=method, pc=pc, options=opts, pc_options=pco, **kw)


def transpose_phase(M, phase, kw):
    """(the system's name, A, [(cell, b ↦ (x, info))]) of a phase 28-29 key."""
    if phase in ("28", "29"):
        A = M.sparse.laplacian_3d(128)
        if phase == "28":
            cells = [(m, ir_cell(M, kw, A, m, "ilu0")) for m in ("bicg", "qmr", "cgnr", "lsqr")]
        else:
            cells = [(c, ir_cell(M, kw, A, m, pc, restart, **extra))
                     for c, m, pc, restart, extra in RELAX_CELLS]
        return "laplacian_3d(128)", A, cells
    if phase == "28cd":
        A = M.sparse.convection_diffusion_2d(1024)
        return ("convection_diffusion_2d(1024)", A,
                [(m, ir_cell(M, kw, A, m, "ilu0")) for m in ("bicg", "qmr")])
    if phase in ("28tall", "28hyb"):
        N = 1024 if phase == "28tall" else 128
        A = tall_system(M, N)
        opts = M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=20000)
        if M is T:
            dev = A
        elif phase == "28tall":             # the route JAX can take
            dev = M.sparse.convert.csr_to_ell(A)
        else:                               # JAX's own route: HYB
            dev = M.sparse.convert.to_device_format(A)
        return (f"[laplacian_2d({N}); 0.1 I]", A,
                [("lsqr", lambda b: M.solve(dev, b, method="lsqr", options=opts, **kw))])
    if phase == "28dist":
        A = M.sparse.laplacian_3d(128)
        if M is T:
            mesh = T.make_mesh(8, devices=[DEVICE] * 8)
        else:
            from lssp_tpu.parallel.dist_solve import make_mesh
            mesh = make_mesh(8)
        opts = M.SolverOptions(**IR_OPTS)
        dist = M.parallel.dist_solve_ir if M is T else \
            importlib.import_module("lssp_tpu.parallel.dist_solve").dist_solve_ir
        return "laplacian_3d(128)", A, [
            (f"dist {m}+{pc}", (lambda m, pc: lambda b: dist(
                A, b, method=m, pc=pc, mesh=mesh, options=opts,
                pc_options=M.PCOptions(ilu_sweeps=6)))(m, pc))
            for m, pc in (("bicg", "bjilu"), ("qmr", "jacobi"))]
    raise ValueError(f"unknown phase {phase!r}")


def run_transpose(M, kw, phases, only, bump, ulp):
    for p in phases:
        name, A, cells = transpose_phase(M, p, kw)
        S = A.to_scipy()
        tall = p in ("28tall", "28hyb")
        for cell, run in cells:
            if only and cell not in only:
                continue
            runs = []
            for seed in ([None, 0, 1, 2] if ulp and not tall else [None]):
                ones = S @ np.ones(S.shape[1]) if tall else np.ones(A.shape[0])
                if seed is not None:        # three entries of b one ulp up
                    ones[np.random.default_rng(seed).integers(0, A.shape[0], 3)] = bump
                b = torch.from_numpy(ones).to(DEVICE) if PORT else ones
                t0 = time.perf_counter()
                try:
                    x, info = run(b)
                except Exception as e:      # 28hyb: JAX's own route fails
                    runs.append(dict(error=f"{type(e).__name__}: {e}"[:300],
                                     seconds=round(time.perf_counter() - t0, 1)))
                    continue
                x = x.cpu().numpy() if PORT else np.asarray(x)
                r = ones - S @ x
                out = dict(nits=int(info.nits), converged=bool(info.converged),
                           relres=float(np.linalg.norm(r) / np.linalg.norm(ones)),
                           seconds=round(time.perf_counter() - t0, 1))
                if tall:
                    out["normal_relres"] = float(np.linalg.norm(S.T @ r)
                                                 / np.linalg.norm(S.T @ ones))
                runs.append(out)
            line = dict(package=M.__name__, device=DEVICE if PORT else "cpu", phase=p,
                        matrix=name, cell=cell, **runs[0])
            if len(runs) > 1:
                line["ulp"] = [(r["nits"], r["converged"]) for r in runs[1:]]
            print(json.dumps(line), flush=True)


TRANSPOSE_PHASES = ("28", "28cd", "28tall", "28hyb", "28dist", "29")
DIRECT_PHASES = ("30", "31")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def vendored(M, name):
    return M.sparse.read_matrix_market(os.path.join(HERE, "benchmarks", "matrices",
                                                    name + ".mtx.gz"))


def schedule_stats(F, lower):
    """JAX's padded level schedule of one factor: nlev, the widest level w,
    the longest row k, nlev·w·k, and Σ over the levels of w_l·k_l."""
    from lssp_tpu_torch import native
    from lssp_tpu_torch.sparse.utils import split_ldu
    S = split_ldu(T.CSR(np.asarray(F.indptr), np.asarray(F.indices), np.asarray(F.data),
                        F.shape))[0 if lower else 2]
    ip = np.asarray(S.indptr, np.int64)
    lev = native.levels(ip, np.asarray(S.indices, np.int64), F.shape[0], lower)
    nlev = int(lev.max()) + 1
    width = np.bincount(lev, minlength=nlev)
    rlen = np.diff(ip)
    kl = np.zeros(nlev, np.int64)
    np.maximum.at(kl, lev, rlen)
    return dict(nnz=int(F.nnz), nlev=nlev, w=int(width.max()), k=int(rlen.max()),
                slots=nlev * int(width.max()) * int(rlen.max()),
                slots_per_level=int((width * np.maximum(kl, 1)).sum()))


def direct_systems(M):
    """The factored systems of phase 30: name ↦ host CSR."""
    import scipy.sparse as sp
    tall = tall_system(M, 256).to_scipy()
    G = (tall.T @ tall).tocsr()
    G.sort_indices()
    return {"laplacian_2d(512)": M.sparse.laplacian_2d(512),
            "coupled3d_25": vendored(M, "coupled3d_25"),
            "convdiff_rot_128": vendored(M, "convdiff_rot_128"),
            "A^T A of [laplacian_2d(256); 0.1 I]": M.sparse.CSR.from_scipy(G)}


def run_direct_30(M, only):
    from importlib import import_module
    lu_host = import_module(f"{M.__name__}.pc.lu_host")
    for name, A in direct_systems(M).items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        f = lu_host.splu_factor(A)
        secs = time.perf_counter() - t0
        print(json.dumps(dict(package=M.__name__, phase="30", matrix=name, n=A.shape[0],
                              factor_seconds=round(secs, 2), nclamped=int(f.nclamped),
                              L=schedule_stats(f.L, True), U=schedule_stats(f.U, False))),
              flush=True)
    if only and "lsq" not in only:
        return
    import scipy.sparse.linalg as spla
    A = tall_system(M, 256)
    S = A.to_scipy()
    bh = S @ np.ones(S.shape[1])
    for method in ("qr",) if M is not T else ("qr", "normal"):
        t0 = time.perf_counter()
        kw = dict(device=DEVICE) if M is T else {}
        x, res = M.solve_lsq(A, bh, method=method, **kw)
        secs = time.perf_counter() - t0
        x = x.cpu().numpy() if M is T else np.asarray(x)
        xs = spla.spsolve((S.T @ S).tocsc(), S.T @ bh)
        print(json.dumps(dict(package=M.__name__, phase="30", cell=f"solve_lsq {method}",
                              matrix="[laplacian_2d(256); 0.1 I]", shape=list(S.shape),
                              seconds=round(secs, 2),
                              normal_relres=float(res / np.linalg.norm(S.T @ bh)),
                              x_vs_spsolve=float(np.linalg.norm(x - xs) / np.linalg.norm(xs)))),
              flush=True)


def tiny_diagonal(M, n=128):
    """``tests/test_ilu.py: test_robust_on_tiny_diagonal``'s matrix."""
    import scipy.sparse as sp
    d = np.r_[np.full(50, 1e-14), np.ones(n - 50)]
    m = (sp.diags(d) + 0.5 * sp.diags(np.ones(n - 1), 1)
         + 0.3 * sp.diags(np.ones(n - 1), -1)).tocsr()
    return M.sparse.CSR.from_scipy(m)


def phase31_cells(M, kw):
    """[(cell, A, b ↦ (x, info, extra))] of phase 31."""
    ir = M.SolverOptions(**IR_OPTS, restart=30)

    def ir_run(A, method, pc, opts=ir, **pco):
        po = M.PCOptions(ilu_sweeps=6, **pco)

        def run(b):
            M32 = M.prepare_ir(A, method=method, pc=pc, pc_options=po, **kw)[4]
            x, info = M.solve_ir(A, b, method=method, pc=pc, options=opts, pc_options=po, **kw)
            extra = {}
            if pc == "ilutp":
                perm = np.asarray(M32.state[2].cpu() if M is T else M32.state[2])
                extra["moved"] = int((perm != np.arange(len(perm))).sum())
            if pc == "arms":
                extra["levels"] = len(M32.state[0])
                extra["coarse_n"] = int(len(M32.state[1][2]) if M is T
                                        else M32.state[1][2].shape[0])
            return x, info, extra
        return run

    def pivot(sweeps):
        A = tiny_diagonal(M)

        def run(b):
            x, info = M.solve(A, b, method="gmres", pc="ilutp",
                              options=M.SolverOptions(maxit=200),
                              pc_options=M.PCOptions(ilu_sweeps=sweeps), **kw)
            return x, info, {}
        return (f"ilutp pivot n=128 {'exact' if sweeps == 0 else f'{sweeps} sweeps'}", A, run)

    cd = M.sparse.convection_diffusion_2d(256)
    c3 = vendored(M, "coupled3d_25")
    an = M.sparse.anisotropic_poisson_2d(256, 0.01)
    lap = M.sparse.laplacian_3d(128)
    cells = [("gmres30+ilutp coupled3d_25", c3, ir_run(c3, "gmres", "ilutp")),
             ("gmres30+ilutp convdiff_256", cd, ir_run(cd, "gmres", "ilutp")),
             pivot(6), pivot(0),
             ("gmres30+arms convdiff_256", cd, ir_run(cd, "gmres", "arms")),
             ("gmres30+arms aniso_256", an, ir_run(an, "gmres", "arms"))]
    for kind, A128 in (("convdiff", M.sparse.convection_diffusion_2d(128)),
                       ("aniso", M.sparse.anisotropic_poisson_2d(128, 0.01))):
        cells.append((f"gmres30+arms {kind}_128", A128, ir_run(A128, "gmres", "arms")))
    for cell, method in (("cg+ilu0", "cg"), ("pipecg+ilu0", "pipecg"),
                         ("gmres30+ilu0", "gmres"), ("cagmres30+ilu0", "cagmres")):
        cells.append((cell + " 128^3", lap, ir_run(lap, method, "ilu0")))
    if M is T:
        mesh = T.make_mesh(8, devices=[DEVICE] * 8)
        dist = T.dist_solve_ir
    else:
        mesh = importlib.import_module("lssp_tpu.parallel.dist_solve").make_mesh(8)
        dist = importlib.import_module("lssp_tpu.parallel.dist_solve").dist_solve_ir
    cells.append(("dist pipecg+bjilu 128^3", lap, lambda b: dist(
        lap, b, method="pipecg", pc="bjilu", mesh=mesh, options=M.SolverOptions(**IR_OPTS),
        pc_options=M.PCOptions(ilu_sweeps=6)) + ({},)))
    return cells


def run_direct(M, kw, phases, only, bump, ulp):
    for p in phases:
        if p == "30":
            run_direct_30(M, only)
            continue
        for cell, A, run in phase31_cells(M, kw):
            if only and not any(o in cell for o in only):
                continue
            S = A.to_scipy()
            runs = []
            for seed in ([None, 0, 1, 2] if ulp else [None]):
                ones = np.ones(A.shape[0])
                if seed is not None:        # three entries of b one ulp up
                    ones[np.random.default_rng(seed).integers(0, A.shape[0], 3)] = bump
                b = torch.from_numpy(ones).to(DEVICE) if PORT else ones
                t0 = time.perf_counter()
                x, info, extra = run(b)
                x = x.cpu().numpy() if PORT else np.asarray(x)
                runs.append(dict(nits=int(info.nits), converged=bool(info.converged),
                                 relres=float(np.linalg.norm(ones - S @ x)
                                              / np.linalg.norm(ones)),
                                 seconds=round(time.perf_counter() - t0, 1), **extra))
            line = dict(package=M.__name__, device=DEVICE if PORT else "cpu", phase=p,
                        cell=cell, n=A.shape[0], **runs[0])
            if len(runs) > 1:
                line["ulp"] = [(r["nits"], r["converged"]) for r in runs[1:]]
            print(json.dumps(line), flush=True)


def tour_cells(M, kw, scale=1.0, sweeps=None, dist=True):
    """The sections of ``examples/tour.py`` and ``examples/distributed.py``
    for the package ``M`` (``lssp_tpu``, or the port with ``kw`` its
    device), as ``lssp_tpu_torch/examples/tour.py`` sizes them at
    ``scale``: {section: (count, true residual)} (``lsq``: the two relative
    errors; the multi-rhs sections: per-column lists).  ``sweeps``: the
    ILU-family PCs' ``ilu_sweeps`` (None: the package default, exact on
    the CPU; 6 is the card's and the TPU's default)."""
    from lssp_tpu_torch.examples.tour import sizes
    port = M is T
    dev = kw.get("device", "cpu")
    z = sizes(scale)
    pco = M.PCOptions(ilu_sweeps=sweeps)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=dev) if port else \
            np.asarray(v, np.float64)

    def host(x):
        return x.cpu().double().numpy() if port else np.asarray(x, np.float64)

    def res(A, x, b):
        return float(np.linalg.norm(np.asarray(b, np.float64) - A.to_scipy() @ host(x)))

    out = {}
    A = M.sparse.convection_diffusion_2d(z["nc"], beta=15.0)
    S = M.sparse.laplacian_2d(z["ns"])
    b, bs = np.ones(A.shape[0]), np.ones(S.shape[0])
    x, info = M.solve(A, vec(b), method="direct")
    out["direct"] = (int(info.nits), res(A, x, b))
    for pc in ("arms", "amg", "rsamg", "iluk"):
        x, info = M.solve(S, vec(bs), method="cg", pc=pc, pc_options=pco)
        out[f"cg+{pc}"] = (int(info.nits), res(S, x, bs))
    for m in ("bicg", "qmr", "cgnr", "lsqr"):
        x, info = M.solve(A, vec(b), method=m, pc="ilut", pc_options=pco)
        out[m] = (int(info.nits), res(A, x, b))
    x, info = M.solve_ir(S, vec(bs), method="cg", pc="amg", **kw)
    out["ir"] = (int(info.nits), res(S, x, bs))
    rng = np.random.default_rng(0)
    m, k = z["m"], z["k"]
    T0 = sp.random(m, k, density=0.03, random_state=1, format="csr")
    T0 = (T0 + sp.vstack([sp.eye(k), sp.csr_matrix((m - k, k))])).tocsr()
    Tm = M.sparse.CSR.from_scipy(T0 @ sp.diags(np.logspace(0, -8, k)))
    xt = rng.standard_normal(k)
    bt = Tm.to_scipy() @ xt
    xq, _ = M.solve_lsq(Tm, bt, **kw)
    xn, _ = M.solve_lsq(Tm, bt, method="normal", **kw)
    out["lsq"] = tuple(float(np.linalg.norm(host(v) - xt) / np.linalg.norm(xt)) for v in (xq, xn))
    nh = z["nh"]
    Sh = M.sparse.laplacian_2d(nh).to_scipy().tolil()
    for i, j in zip(rng.integers(0, nh * nh, z["strays"]), rng.integers(0, nh * nh, z["strays"])):
        Sh[i, j] += 0.02
    Ah = M.sparse.CSR.from_scipy(Sh.tocsr())
    _, ih = M.solve(Ah, vec(np.ones(nh * nh)), method="gmres")
    out["hyb"] = (int(ih.nits), None)
    bf16 = torch.bfloat16 if port else importlib.import_module("jax.numpy").bfloat16
    x, info = M.solve_ir(S, vec(bs), method="cg", pc="ilu0", inner_dtype=bf16, inner_rtol=3e-2,
                         options=M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0), max_outer=60,
                         pc_options=pco, **kw)
    out["bf16"] = (int(info.nits), res(S, x, bs))
    Bm = np.stack([bs, rng.standard_normal(S.shape[0])], axis=1)

    def cols(X):
        return [float(np.linalg.norm(Bm[:, j] - S.to_scipy() @ host(X)[:, j])) for j in range(2)]
    X, im = M.solve_multi(S, vec(Bm), method="cg", pc="iluk", pc_options=pco)
    out["multi"] = ([int(v) for v in np.asarray(im.nits)], cols(X))
    X, ib = M.solve_multi(S, vec(Bm), method="blockcg", pc="iluk", pc_options=pco)
    out["blockcg"] = ([int(v) for v in np.asarray(ib.nits)], cols(X))
    X, ir_ = M.solve_ir_multi(S, vec(Bm), method="blockcg", pc="iluk", pc_options=pco,
                              options=M.SolverOptions(rtol=1e-10, atol=0.0), **kw)
    out["ir_multi"] = ([int(v) for v in np.asarray(ir_.nits)], cols(X))
    ck = importlib.import_module(("lssp_tpu_torch" if port else "lssp_tpu")
                                 + ".utils.checkpoint").checkpointed_solve
    path = os.path.join(tempfile.mkdtemp(prefix="lssp_tour_ref_"), "run.ckpt")
    ckw = dict(every=20, method="cg", pc="iluk", pc_options=pco, **kw)
    _, info = ck(S, vec(bs), path, max_rounds=1, **ckw)
    out["ckpt_interrupted"] = (int(info.nits), bool(info.converged))
    x, info = ck(S, vec(bs), path, **ckw)
    out["ckpt"] = (int(info.nits), res(S, x, bs))
    if dist:
        L = M.sparse.laplacian_2d(z["ns"])
        if port:
            mesh = T.make_mesh(8, devices=[dev] * 8)
            dsolve = T.dist_solve
        else:
            from lssp_tpu.parallel.dist_solve import dist_solve as dsolve, make_mesh
            mesh = make_mesh(8)
        bl = np.ones(L.shape[0])
        for method, pc in (("cg", "bjilu"), ("cg", "saamg"), ("bicgstab", "bjilu")):
            x, info = dsolve(L, vec(bl), method=method, pc=pc, mesh=mesh,
                             options=M.SolverOptions(maxit=500), pc_options=pco)
            out[f"dist {method}+{pc}"] = (int(info.nits), res(L, x, bl))
    return out


def strayed_3d(M, N, seed=5):
    """``chip_smoke.py: strayed_grid``'s 3-D recipe: the Laplacian N³ plus
    max(n // 200, 8) entries of 0.01 from default_rng(seed)."""
    S = M.sparse.laplacian_3d(N).to_scipy().tocoo()
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    k = max(n // 200, 8)
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    return M.sparse.CSR.from_scipy((S + sp.coo_matrix((np.full(k, 0.01), (r, c)),
                                                      shape=S.shape)).tocsr())


def run_bf16(M, kw, only):
    """``32``: ``solve_ir`` with a bf16 inner solve (inner_rtol 3e-2,
    max_outer 60, rtol 1e-8, ILU(0) at 6 sweeps), b = 1: cg on the 3-D
    Laplacian 64³ (the cell ``chip_smoke.py`` phase 32 holds), and
    bicgstab, gmres and cg on the strayed 64³ (phase 8's recipe at 64³)."""
    bf16 = torch.bfloat16 if M is T else importlib.import_module("jax.numpy").bfloat16
    cells = [("cg", "laplacian_3d(64)", lambda: M.sparse.laplacian_3d(64))] + [
        (m, "laplacian_3d(64)+strays", lambda: strayed_3d(M, 64))
        for m in ("bicgstab", "gmres", "cg")]
    for method, name, make in cells:
        if only and method not in only:
            continue
        A = make()
        n = A.shape[0]
        b = torch.ones(n, dtype=torch.float64, device=DEVICE) if M is T else np.ones(n)
        t0 = time.perf_counter()
        x, info = M.solve_ir(A, b, method=method, pc="ilu0", inner_dtype=bf16, inner_rtol=3e-2,
                             max_outer=60, options=M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0),
                             pc_options=M.PCOptions(ilu_sweeps=6), **kw)
        x = x.cpu().numpy() if M is T else np.asarray(x)
        rr = float(np.linalg.norm(1.0 - A.to_scipy() @ x) / np.sqrt(n))
        print(json.dumps(dict(package=M.__name__, device=kw.get("device", "cpu"), phase=32,
                              matrix=name, method=method, nits=int(info.nits),
                              converged=bool(info.converged), relres=rr,
                              seconds=round(time.perf_counter() - t0, 1))), flush=True)


def run_tour(M, kw):
    """``tour``: every section of the two examples at full size, with the
    card's 6 Neumann sweeps (``--exact``: the CPU default), one JSON line
    each."""
    sweeps = None if "--exact" in sys.argv else 6
    t0 = time.perf_counter()
    for cell, val in tour_cells(M, kw, sweeps=sweeps).items():
        print(json.dumps(dict(package=M.__name__, device=kw.get("device", "cpu"), phase="tour",
                              sweeps=sweeps, cell=cell, value=val)), flush=True)
    print(json.dumps(dict(package=M.__name__, phase="tour",
                          seconds=round(time.perf_counter() - t0, 1))))


def main():
    if "--shadow" in sys.argv:
        return shadow()
    if "--ratchet-ulp" in sys.argv:
        return ratchet_ulp()
    if PORT:
        M, kw = T, dict(device=DEVICE)
    else:
        _, M = jax_package()
        kw = {}
    phases = {23: ("laplacian_3d(128)", lambda: M.sparse.laplacian_3d(128), METHODS),
              24: ("convection_diffusion_2d(1024)",
                   lambda: M.sparse.convection_diffusion_2d(1024),
                   [m for m in METHODS if m != "minres"])}
    ulp = "--ulp" in sys.argv or "--ulp32" in sys.argv
    bump = float(np.nextafter(np.float32(1), np.float32(2))) if "--ulp32" in sys.argv \
        else np.nextafter(1.0, 2.0)
    args = [a for a in sys.argv[1:] if a not in ("--port", "--ulp", "--ulp32", "--device",
                                                 DEVICE, "--jax-shadow", "--jax-cap",
                                                 "--exact")]
    if "tour" in args:
        return run_tour(M, kw)
    if "32" in args:
        return run_bf16(M, kw, [a for a in args if a != "32"])
    direct = [a for a in args if a in DIRECT_PHASES]
    if direct:
        return run_direct(M, kw, direct, [a for a in args if a not in direct], bump, ulp)
    transpose = [a for a in args if a in TRANSPOSE_PHASES]
    if transpose:
        return run_transpose(M, kw, transpose, [a for a in args if a not in transpose], bump,
                             ulp)
    only = [a for a in args if not a.isdigit()]
    opts = M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    pco = M.PCOptions(ilu_sweeps=6)
    for p in [int(a) for a in args if a.isdigit()] or sorted(phases):
        name, make, methods = phases[p]
        A = make()
        S = A.to_scipy()
        if "--jax-shadow" in sys.argv:
            from lssp_tpu_torch.solvers import idrs
            n = A.shape[0]
            P = torch.from_numpy(np.array(jax_shadow(4, n, "float32"))).to(DEVICE)
            idrs._SHADOW[(4, n, torch.float32, str(torch.device(DEVICE)), 1)] = P
        for method in only or methods:
            runs = []
            for seed in ([None, 0, 1, 2] if ulp else [None]):
                ones = np.ones(A.shape[0])
                if seed is not None:        # three entries of b one ulp up
                    ones[np.random.default_rng(seed).integers(0, A.shape[0], 3)] = bump
                b = torch.from_numpy(ones).to(DEVICE) if PORT else ones
                t0 = time.perf_counter()
                x, info = M.solve_ir(A, b, method=method, pc="ilu0", options=opts,
                                     pc_options=pco, **kw)
                x = x.cpu().numpy() if PORT else np.asarray(x)
                rr = float(np.linalg.norm(ones - S @ x) / np.linalg.norm(ones))
                runs.append(dict(nits=int(info.nits), converged=bool(info.converged),
                                 relres=rr, seconds=round(time.perf_counter() - t0, 1)))
            line = dict(package=M.__name__, device=DEVICE if PORT else "cpu", phase=p,
                        matrix=name, method=method, **runs[0])
            if len(runs) > 1:
                line["ulp"] = [(r["nits"], r["converged"]) for r in runs[1:]]
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
