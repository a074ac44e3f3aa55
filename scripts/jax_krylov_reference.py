#!/usr/bin/env python3
"""Iteration counts for the Krylov phases of ``chip_smoke.py`` (23 and 24):
the JAX package's on the CPU, the reference the port's counts on the card
are held to, and with ``--port`` the port's own.

    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--ulp]
                                                              [23|24] [method ...]
    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py --shadow

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
count that moves under such changes moves with rounding alone.

``--shadow`` prints, in fp32 at n = 2,097,152 (128³), the relative error
of JAX's ``jnp.dot`` and ``jnp.sum(a * b)`` and of ``torch.dot`` against
an fp64 sum, and how far IDR(s)'s shadow space after MGS is from
orthonormal in each package (``lssp_tpu/solvers/idrs.py:37-44`` orthogonalizes
with ``jnp.dot``).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lssp_tpu_torch as T  # noqa: E402

PORT = "--port" in sys.argv
DEVICE = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cpu"
METHODS = ["cgs", "cr", "crs", "bicrstab", "bicgsafe", "bicrsafe", "gpbicg", "gpbicr",
           "qmrcgstab", "tfqmr", "orthomin", "bicgstabl", "idrs", "lgmres", "rlgmres",
           "minres", "fgmres"]


def jax_package():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import lssp_tpu
    return jax, lssp_tpu


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
    P = jax.random.uniform(jax.random.PRNGKey(0), (s, n), dtype=jnp.float32)

    def orth(j, P):                         # lssp_tpu/solvers/idrs.py:37-44
        pj = P[j] / jnp.sqrt(jnp.dot(P[j], P[j]))
        P = P.at[j].set(pj)
        return jax.lax.fori_loop(0, s, lambda i, P: jax.lax.cond(
            i > j, lambda P: P.at[i].set(P[i] - jnp.dot(pj, P[i]) * pj), lambda P: P, P), P)
    Pj = np.asarray(jax.lax.fori_loop(0, s, orth, P), np.float64)
    Pt = shadow_space(s, n, torch.float32, "cpu").numpy().astype(np.float64)
    print(json.dumps({"n": n, "s": s, "max |P P^T - I|": {
        "lssp_tpu": float(np.abs(Pj @ Pj.T - np.eye(s)).max()),
        "lssp_tpu_torch": float(np.abs(Pt @ Pt.T - np.eye(s)).max())},
        "max |P_jax - P_torch|": float(np.abs(Pj - Pt).max())}))


def main():
    if "--shadow" in sys.argv:
        return shadow()
    if PORT:
        M, kw = T, dict(device=DEVICE)
    else:
        _, M = jax_package()
        kw = {}
    phases = {23: ("laplacian_3d(128)", lambda: M.sparse.laplacian_3d(128), METHODS),
              24: ("convection_diffusion_2d(1024)",
                   lambda: M.sparse.convection_diffusion_2d(1024),
                   [m for m in METHODS if m != "minres"])}
    args = [a for a in sys.argv[1:] if a not in ("--port", "--ulp", "--device", DEVICE)]
    only = [a for a in args if not a.isdigit()]
    opts = M.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    pco = M.PCOptions(ilu_sweeps=6)
    for p in [int(a) for a in args if a.isdigit()] or sorted(phases):
        name, make, methods = phases[p]
        A = make()
        S = A.to_scipy()
        for method in only or methods:
            runs = []
            for seed in ([None, 0, 1, 2] if "--ulp" in sys.argv else [None]):
                ones = np.ones(A.shape[0])
                if seed is not None:        # three entries of b one ulp up
                    ones[np.random.default_rng(seed).integers(0, A.shape[0], 3)] = \
                        np.nextafter(1.0, 2.0)
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
