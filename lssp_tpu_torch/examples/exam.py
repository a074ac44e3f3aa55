"""The reference's example program (reference example/exam.cxx:
61-127), as ``examples/exam.py`` runs it off the TPU: 2-D 5-point
Laplacian at N = 100, GMRES(60) + ILU(1) through the ``Solver``
lifecycle in fp64, maxit 3000, b = 1, x0 = 0, then the independent
true-residual check (:115-116).

    python -m lssp_tpu_torch.examples.exam [N] [--device cpu]

Expected (the serial C reference's): 49 iterations, residual ≈ 8.2e-6.
The card has fp64, so this is JAX's fp64 ``Solver`` branch
(``examples/exam.py:49-60``); the TPU branch (mixed-precision refinement)
exists for a chip without it.  The ILU is applied exactly
(``ilu_sweeps=0``), as JAX applies it on its CPU backend; the port's
default on the card is 6 Neumann sweeps.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lssp_tpu_torch import PCOptions, Solver
from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.sparse import laplacian_2d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", nargs="?", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    N = args.N

    A = laplacian_2d(N)
    n = A.shape[0]
    print(f"CSR: laplacian, grid size {N}")
    print(f"CSR: rows: {n} nonzeros: {A.nnz} "
          f"mem (csr): {((A.nnz + n) * 4 + A.nnz * 8) / 2**20:.3f} Mb")
    b = torch.ones(n, dtype=torch.float64)

    s = Solver(method="gmres", pc="iluk", pc_options=PCOptions(ilu_sweeps=0), device=device)
    s.set_restart(60).set_maxit(3000)
    t0 = time.perf_counter()
    s.assemble(A, b)
    print(f"solver: assemble time: {time.perf_counter() - t0:.6g}")
    t0 = time.perf_counter()
    x = s.solve()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"gmres: total iteration: {s.nits}")
    print(f"total solver time: {time.perf_counter() - t0:.6g}")
    print(f"solution L2 norm: {float(torch.linalg.vector_norm(x)):.8e} "
          f"residual: {s.residual:.8e}")
    r = np.ones(n) - A.to_scipy() @ x.cpu().numpy()
    verification = float(np.linalg.norm(r))
    print(f"verification, residual: {verification:.8e}")
    return {"nits": s.nits, "residual": s.residual, "verification": verification}


if __name__ == "__main__":
    main()
