#!/usr/bin/env python3
"""Iteration counts on the CPU for the AMG phases of ``chip_smoke.py``
(19-22): the JAX package's, the reference the port's counts on the card
are held to, and with ``--port`` the port's own on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_amg_reference.py [--port] [phase ...]

Each phase solves the system of its ``chip_smoke.py`` phase, at a size cut
for a CPU where the phase runs at 1024² (phase 19 at 256², phase 20 at
512², the size phase 20 itself runs at), and prints one JSON line: the
package, the phase, the size, the inner iteration count(s) and the true
relative residual recomputed with scipy.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


PHASES = {"19": phase19, "20": phase20, "21": phase21, "22": phase22}


def main():
    for p in [a for a in sys.argv[1:] if a != "--port"] or sorted(PHASES):
        t0 = time.perf_counter()
        out = PHASES[p]()
        print(json.dumps(dict(package=M.__name__, phase=int(p),
                              seconds=round(time.perf_counter() - t0, 1), **out)), flush=True)


if __name__ == "__main__":
    main()
