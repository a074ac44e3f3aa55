#!/usr/bin/env python3
"""Iteration counts on the CPU for the AMG and block phases of
``chip_smoke.py`` (19-22, 26-27): the JAX package's, the reference the
port's counts on the card are held to, and with ``--port`` the port's own
on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_amg_reference.py [--port] [phase ...]

Each phase solves the system of its ``chip_smoke.py`` phase, at a size cut
for a CPU where the phase runs at 1024² (phase 19 at 256², phase 20 at
512², the size phase 20 itself runs at), and prints one JSON line: the
package, the phase, the size, the inner iteration count(s) and the true
relative residual recomputed with scipy.  Phases 26-27 run at the card's
full sizes: 26 ``solve_ir`` BiCGSTAB(l) + biluk (2×2 blocks, 6 sweeps) on
the elasticity 512² as a BSR, 26acc the acceptance config
``bicgstabl_biluk_elasticity`` (``solve_ir`` with 6 sweeps, also under six
changes of b by one fp32 ulp, and the fp64 ``Solver`` with exact
schedules), 26multi ``solve_ir_multi`` block CG +
biluk k = 4 on the 512² BSR; 27 ``dist_solve_ir`` GMRES(30) + saamg on the
anisotropic 1024² over 8 shards (and the single-device ``solve_ir``),
27rs ``dist_solve_ir`` CG + rsamg on 64³, 27amg ``dist_solve`` GMRES(30) +
amg fp64 on the anisotropic 512², 27multi ``dist_solve_ir_multi`` block
CG + saamg 512², k = 8.  JAX's 8 shards are 8 host devices
(``--xla_force_host_platform_device_count=8``, set here), the port's an
8-slot CPU mesh.  Phases 26-27 take minutes each for JAX.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch  # noqa: E402

import lssp_tpu as J  # noqa: E402
import lssp_tpu_torch as T  # noqa: E402

PORT = "--port" in sys.argv
M = T if PORT else J
KW = dict(device="cpu") if PORT else {}
OPTS = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)


def relres(A, x, b):
    b = np.asarray(b)
    return np.linalg.norm(b - A.to_scipy() @ np.asarray(x), axis=0) / np.linalg.norm(b, axis=0)


def vec(a):
    return torch.from_numpy(np.asarray(a, np.float64)) if PORT else jnp.asarray(a)


def phase19():
    A = M.sparse.anisotropic_poisson_2d(256, epsilon=0.01)
    b = vec(np.ones(A.shape[0]))
    x, info = M.solve_ir(A, b, method="gmres", pc="saamg",
                         options=M.SolverOptions(restart=30, **OPTS), **KW)
    return dict(matrix="anisotropic_poisson_2d(256, epsilon=0.01)", n=A.shape[0],
                call="solve_ir gmres(30)+saamg", nits=int(info.nits),
                relres=float(relres(A, x, b)))


def phase20():
    A = M.sparse.anisotropic_poisson_2d(512)
    b = vec(np.ones(A.shape[0]))
    opts = M.SolverOptions(restart=30, **dict(OPTS, maxit=5000))
    s = M.Solver(method="gmres", pc="amg", options=opts, **KW)
    s.assemble(A, b)
    x = s.solve()
    return dict(matrix="anisotropic_poisson_2d(512)", n=A.shape[0],
                call="Solver gmres(30)+amg fp64", nits=int(s.nits),
                relres=float(relres(A, x, b)))


def phase21():
    A = M.sparse.laplacian_3d(64)
    b = vec(np.ones(A.shape[0]))
    x, info = M.solve_ir(A, b, method="cg", pc="rsamg", options=M.SolverOptions(**OPTS), **KW)
    return dict(matrix="laplacian_3d(64)", n=A.shape[0], call="solve_ir cg+rsamg",
                nits=int(info.nits), relres=float(relres(A, x, b)))


def phase22():
    A = M.sparse.anisotropic_poisson_2d(512, epsilon=0.01)
    B = vec(np.random.default_rng(0).standard_normal((A.shape[0], 8)))
    X, info = M.solve_ir_multi(A, B, method="blockgmres", pc="saamg",
                               options=M.SolverOptions(restart=30, **OPTS), **KW)
    return dict(matrix="anisotropic_poisson_2d(512, epsilon=0.01)", n=A.shape[0],
                call="solve_ir_multi blockgmres+saamg k=8",
                nits=[int(v) for v in np.asarray(info.nits)],
                relres=[float(v) for v in relres(A, X, B)])


def ir_opts(**kw):
    return M.SolverOptions(**dict(OPTS, **kw))


def phase26():
    A = M.sparse.csr_to_bsr(M.sparse.elasticity_2d(512), 2)
    b = vec(np.ones(A.shape[0]))
    x, info = M.solve_ir(A, b, method="bicgstabl", pc="biluk", options=ir_opts(),
                         pc_options=M.PCOptions(block_size=2, ilu_sweeps=6), **KW)
    return dict(matrix="csr_to_bsr(elasticity_2d(512), 2)", n=A.shape[0],
                call="solve_ir bicgstabl+biluk 6 sweeps", nits=int(info.nits),
                relres=float(relres(A, x, b)))


def phase26acc():
    A = M.sparse.elasticity_2d(48)
    b = vec(np.ones(A.shape[0]))
    x, info = M.solve_ir(A, b, method="bicgstabl", pc="biluk", options=ir_opts(),
                         pc_options=M.PCOptions(block_size=2, ilu_sweeps=6), **KW)
    s = M.Solver(method="bicgstabl", pc="biluk", options=ir_opts(),
                 pc_options=M.PCOptions(block_size=2, ilu_sweeps=0), **KW)
    s.assemble(A, b)
    xs = s.solve()
    # the solve_ir count under six changes of b that the fp32 inner solves
    # see: three entries one fp32 ulp up (1 + 2^-23), seeds 0-5
    spread = []
    for seed in range(6):
        ones = np.ones(A.shape[0])
        ones[np.random.default_rng(seed).integers(0, A.shape[0], 3)] = \
            float(np.nextafter(np.float32(1), np.float32(2)))
        spread.append(int(M.solve_ir(A, vec(ones), method="bicgstabl", pc="biluk",
                                     options=ir_opts(), pc_options=M.PCOptions(
                                         block_size=2, ilu_sweeps=6), **KW)[1].nits))
    return dict(matrix="elasticity_2d(48)", n=A.shape[0],
                call="bicgstabl_biluk_elasticity: solve_ir 6 sweeps; Solver fp64 exact",
                nits=[int(info.nits), int(s.nits)], ulp32=spread,
                relres=[float(relres(A, x, b)), float(relres(A, xs, b))])


def phase26multi():
    A = M.sparse.csr_to_bsr(M.sparse.elasticity_2d(512), 2)
    B = vec(np.random.default_rng(0).standard_normal((A.shape[0], 4)))
    X, info = M.solve_ir_multi(A, B, method="blockcg", pc="biluk", options=ir_opts(),
                               pc_options=M.PCOptions(block_size=2, ilu_sweeps=6), **KW)
    return dict(matrix="csr_to_bsr(elasticity_2d(512), 2)", n=A.shape[0],
                call="solve_ir_multi blockcg+biluk 6 sweeps k=4",
                nits=[int(v) for v in np.asarray(info.nits)],
                relres=[float(v) for v in relres(A, X, B)])


def mesh8():
    if PORT:
        return T.make_mesh(8, devices=["cpu"] * 8)
    from lssp_tpu.parallel.dist_solve import make_mesh
    return make_mesh(8)


def dist(name):
    if PORT:
        return getattr(T, name)
    from lssp_tpu.parallel import dist_solve
    return getattr(dist_solve, name)


def phase27():
    A = M.sparse.anisotropic_poisson_2d(1024, epsilon=0.01)
    b = vec(np.ones(A.shape[0]))
    x, info = dist("dist_solve_ir")(A, b, method="gmres", pc="saamg", mesh=mesh8(),
                                    options=ir_opts(restart=30))
    x1, i1 = M.solve_ir(A, b, method="gmres", pc="saamg", options=ir_opts(restart=30), **KW)
    return dict(matrix="anisotropic_poisson_2d(1024, epsilon=0.01)", n=A.shape[0],
                call="dist_solve_ir gmres(30)+saamg, 8 shards; solve_ir single device",
                nits=[int(info.nits), int(i1.nits)],
                relres=[float(relres(A, x, b)), float(relres(A, x1, b))])


def phase27rs():
    A = M.sparse.laplacian_3d(64)
    b = vec(np.ones(A.shape[0]))
    x, info = dist("dist_solve_ir")(A, b, method="cg", pc="rsamg", mesh=mesh8(),
                                    options=ir_opts())
    return dict(matrix="laplacian_3d(64)", n=A.shape[0],
                call="dist_solve_ir cg+rsamg, 8 shards", nits=int(info.nits),
                relres=float(relres(A, x, b)))


def phase27amg():
    A = M.sparse.anisotropic_poisson_2d(512)
    b = vec(np.ones(A.shape[0]))
    x, info = dist("dist_solve")(A, b, method="gmres", pc="amg", mesh=mesh8(),
                                 options=ir_opts(restart=30, maxit=5000))
    return dict(matrix="anisotropic_poisson_2d(512)", n=A.shape[0],
                call="dist_solve gmres(30)+amg fp64, 8 shards", nits=int(info.nits),
                relres=float(relres(A, x, b)))


def phase27multi():
    A = M.sparse.anisotropic_poisson_2d(512, epsilon=0.01)
    B = vec(np.random.default_rng(0).standard_normal((A.shape[0], 8)))
    X, info = dist("dist_solve_ir_multi")(A, B, method="blockcg", pc="saamg", mesh=mesh8(),
                                          options=ir_opts())
    return dict(matrix="anisotropic_poisson_2d(512, epsilon=0.01)", n=A.shape[0],
                call="dist_solve_ir_multi blockcg+saamg, 8 shards, k=8",
                nits=[int(v) for v in np.asarray(info.nits)],
                relres=[float(v) for v in relres(A, X, B)])


PHASES = {"19": phase19, "20": phase20, "21": phase21, "22": phase22, "26": phase26,
          "26acc": phase26acc, "26multi": phase26multi, "27": phase27, "27rs": phase27rs,
          "27amg": phase27amg, "27multi": phase27multi}


def main():
    for p in [a for a in sys.argv[1:] if a != "--port"] or sorted(PHASES):
        t0 = time.perf_counter()
        out = PHASES[p]()
        print(json.dumps(dict(package=M.__name__, phase=p,
                              seconds=round(time.perf_counter() - t0, 1), **out)), flush=True)


if __name__ == "__main__":
    main()
