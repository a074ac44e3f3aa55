"""A tour of the capabilities beyond the reference's example
(``examples/tour.py``, section by section): the direct solve, multilevel
preconditioners, the transpose-based Krylov methods, mixed-precision
refinement (fp32 and bf16 inner), sparse QR least squares, the HYB
format, multiple right-hand sides, block Krylov, and checkpoint / resume.

    python -m lssp_tpu_torch.examples.tour [--scale S] [--device cpu]

``--scale`` shrinks the test problems' sizes (the grids 48, 64 and 48 and
the 240 × 120 least-squares system) and nothing else.  ``main`` returns
each section's counts and residuals.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import scipy.sparse as sp
import torch

import lssp_tpu_torch as lt
from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.sparse.convert import to_device_format
from lssp_tpu_torch.utils.checkpoint import checkpointed_solve


def residual(A, x, b):
    return float(np.linalg.norm(np.asarray(b.cpu(), np.float64)
                                - A.to_scipy() @ x.cpu().double().numpy()))


def _cols_res(S, B, X):
    return [float(np.linalg.norm(B[:, j].cpu().numpy() - S.to_scipy() @ X[:, j].cpu().numpy()))
            for j in range(B.shape[1])]


def sizes(scale: float) -> dict:
    """The tour's problem sizes at ``scale``: the convection-diffusion and
    HYB grids (48), the Laplacian (64) and the least-squares system
    (240 × 120, 40 strays on the HYB grid)."""
    def s(v, lo=4):
        return max(lo, int(round(v * scale)))
    return dict(nc=s(48), ns=s(64), nh=s(48), m=s(240, 16), k=s(120, 8), strays=s(40, 4))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    z = sizes(args.scale)
    out = {}

    A = lt.sparse.convection_diffusion_2d(z["nc"], beta=15.0)    # nonsymmetric
    S = lt.sparse.laplacian_2d(z["ns"])                           # SPD
    b = torch.ones(A.shape[0], dtype=torch.float64, device=device)
    bs = torch.ones(S.shape[0], dtype=torch.float64, device=device)

    print("== native sparse direct LU (UMFPACK/KLU role) ==")
    x, info = lt.solve(A, b, method="direct")
    out["direct"] = (int(info.nits), residual(A, x, b))
    print(f"  nits={int(info.nits)}  true-res={out['direct'][1]:.2e}")

    print("== multilevel PCs: ARMS vs AMG vs ILU(1) ==")
    for pc in ("arms", "amg", "rsamg", "iluk"):
        x, info = lt.solve(S, bs, method="cg", pc=pc)
        out[f"cg+{pc}"] = (int(info.nits), residual(S, x, bs))
        print(f"  cg+{pc:5s} nits={int(info.nits):3d}  res={out[f'cg+{pc}'][1]:.2e}")

    print("== transpose-based methods on the nonsymmetric system ==")
    for m in ("bicg", "qmr", "cgnr", "lsqr"):
        x, info = lt.solve(A, b, method=m, pc="ilut")
        out[m] = (int(info.nits), residual(A, x, b))
        print(f"  {m:5s} nits={int(info.nits):4d}  res={out[m][1]:.2e}")

    print("== mixed-precision iterative refinement (fp32 inner) ==")
    x, info = lt.solve_ir(S, bs, method="cg", pc="amg")
    out["ir"] = (int(info.nits), residual(S, x, bs))
    print(f"  inner-nits={int(info.nits)}  res={out['ir'][1]:.2e}")

    print("== sparse QR least squares (QR_MUMPS role) ==")
    rng = np.random.default_rng(0)
    m, k = z["m"], z["k"]
    T0 = sp.random(m, k, density=0.03, random_state=1, format="csr")
    T0 = (T0 + sp.vstack([sp.eye(k), sp.csr_matrix((m - k, k))])).tocsr()
    T = lt.sparse.CSR.from_scipy(T0 @ sp.diags(np.logspace(0, -8, k)))
    xt = rng.standard_normal(k)
    bt = T.to_scipy() @ xt
    xq, _ = lt.solve_lsq(T, bt, device=device)                   # QR (cond-robust)
    xn, _ = lt.solve_lsq(T, bt, method="normal", device=device)  # squared condition
    eq = np.linalg.norm(xq.cpu().numpy() - xt) / np.linalg.norm(xt)
    en = np.linalg.norm(xn.cpu().numpy() - xt) / np.linalg.norm(xt)
    out["lsq"] = (eq, en)
    print(f"  cond~1e8: qr err {eq:.1e}  normal-eq err {en:.1e}")

    print("== hybrid band+remainder execution format ==")
    nh = z["nh"]
    Sh = lt.sparse.laplacian_2d(nh).to_scipy().tolil()
    for i, j in zip(rng.integers(0, nh * nh, z["strays"]), rng.integers(0, nh * nh, z["strays"])):
        Sh[i, j] += 0.02
    Ah = lt.sparse.CSR.from_scipy(Sh.tocsr())
    H = to_device_format(Ah, max_diags=32, dia_fill=2.0, device=device)
    xh, ih = lt.solve(Ah, torch.ones(nh * nh, device=device), method="gmres")
    out["hyb"] = (int(ih.nits), type(H).__name__)
    print(f"  format={type(H).__name__} (band {len(H.dia.offsets)} diagonals"
          f" + {H.nnz_rem} remainder nnz)  gmres nits={int(ih.nits)}")

    print("== bfloat16 inner refinement ==")
    x, info = lt.solve_ir(S, bs, method="cg", pc="ilu0", inner_dtype=torch.bfloat16,
                          inner_rtol=3e-2,
                          options=lt.SolverOptions(rtol=1e-8, atol=0.0, rbtol=0.0), max_outer=60)
    out["bf16"] = (int(info.nits), residual(S, x, bs))
    print(f"  inner-nits={int(info.nits)}  res={out['bf16'][1]:.2e}"
          "  (half the HBM bytes per inner iteration)")

    print("== multiple right-hand sides (one batched solve) ==")
    Bm = torch.stack([bs, torch.from_numpy(rng.standard_normal(S.shape[0])).to(device)], dim=1)
    Xm, im = lt.solve_multi(S, Bm, method="cg", pc="iluk")
    out["multi"] = ([int(v) for v in im.nits], _cols_res(S, Bm, Xm))
    print(f"  k=2 rhs: nits={out['multi'][0]}  "
          f"res={[f'{v:.1e}' for v in out['multi'][1]]}")

    print("== block Krylov: one SHARED search block for all rhs ==")
    Xb, ib = lt.solve_multi(S, Bm, method="blockcg", pc="iluk")
    out["blockcg"] = ([int(v) for v in ib.nits], _cols_res(S, Bm, Xb))
    print(f"  blockcg nits={out['blockcg'][0]} (vs per-column "
          f"{out['multi'][0]}) — information mixes across rhs; "
          "blockgmres is the nonsymmetric analog")

    print("== multi-rhs mixed precision (fp32 block inner, fp64 answers) ==")
    Xr, ir_ = lt.solve_ir_multi(S, Bm, method="blockcg", pc="iluk",
                                options=lt.SolverOptions(rtol=1e-10, atol=0.0))
    out["ir_multi"] = ([int(v) for v in ir_.nits], _cols_res(S, Bm, Xr))
    print(f"  inner its={out['ir_multi'][0]}  "
          f"res={[f'{v:.1e}' for v in out['ir_multi'][1]]}")

    print("== checkpoint / resume ==")
    path = os.path.join(tempfile.mkdtemp(prefix="lssp_tour_"), "run.ckpt")
    x, info = checkpointed_solve(S, bs, path, every=20, method="cg", pc="iluk", max_rounds=1)
    out["ckpt_interrupted"] = (int(info.nits), bool(info.converged))
    print(f"  interrupted at nits={int(info.nits)} (converged={bool(info.converged)})")
    x, info = checkpointed_solve(S, bs, path, every=20, method="cg", pc="iluk")
    out["ckpt"] = (int(info.nits), residual(S, x, bs))
    print(f"  resumed: total nits={int(info.nits)}  res={out['ckpt'][1]:.2e}")
    return out


if __name__ == "__main__":
    main()
