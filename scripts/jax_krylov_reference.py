#!/usr/bin/env python3
"""Iteration counts for the Krylov phases of ``chip_smoke.py`` (23 and 24):
the JAX package's on the CPU, the reference the port's counts on the card
are held to, and with ``--port`` the port's own.

    JAX_PLATFORMS=cpu python3 scripts/jax_krylov_reference.py [--port [--device D]] [--ulp|--ulp32]
                                                              [23|24] [method ...]
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
                                                 DEVICE, "--jax-shadow")]
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
