"""The distributed solve example (``examples/distributed.py``): the same
Krylov code over a shard mesh.  The JAX example runs 8 devices (8 CPU
devices when there is no TPU slice); here the mesh is 8 shards of one
device, the card's unless given ``--device cpu``.

    python -m lssp_tpu_torch.examples.distributed [--device cpu]

On the 2-D Laplacian 64², b = 1, maxit 500, in fp64 (JAX's choice off the
TPU; the card has fp64): CG + block-Jacobi ILU, CG + saamg and BiCGSTAB +
block-Jacobi ILU.  Several cards (one rank each) wait for the
multi-process communicator.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import lssp_tpu_torch as lt
from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.parallel import dist_solve, make_mesh

CASES = (("cg", "bjilu"), ("cg", "saamg"), ("bicgstab", "bjilu"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=64, help="grid side of the 2-D Laplacian")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_mesh(8, devices=[device] * 8)
    print(f"mesh: {mesh.size} devices ({device.type})")

    A = lt.sparse.laplacian_2d(args.n)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float64)
    out = {}
    for method, pc in CASES:
        x, info = dist_solve(A, b, method=method, pc=pc, mesh=mesh,
                             options=lt.SolverOptions(maxit=500))
        res = float(np.linalg.norm(np.ones(n) - A.to_scipy() @ x.cpu().double().numpy()))
        print(f"  {method}+{pc:6s}: nits={int(info.nits):4d} "
              f"true-res={res:.2e} converged={bool(info.converged)}")
        out[f"{method}+{pc}"] = (int(info.nits), res, bool(info.converged))
    return out


if __name__ == "__main__":
    main()
