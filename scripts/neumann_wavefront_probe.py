#!/usr/bin/env python3
"""K2 / K2k (``lssp_tpu_torch/csrc/neumann.cu``) on one CUDA card: the
build's register and spill report, the kernel against its plain version
(fp32 / fp64, k = 1, 3, 8, repeated applies bitwise equal), and device
times against the HBM bound with the launch's schedule (tiles, blocks in
flight, waves a phase): at ILU(0) 64³ and 128³ and the strayed ILU(1)
256² case, and at 128³ over 1, 2, 4 and 6 sweeps, whose slope is the time
a sweep level adds to an apply.

    python3 scripts/neumann_wavefront_probe.py

Needs a CUDA card and nvcc; prints one line per measurement.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import lssp_tpu_torch as lt  # noqa: E402
from chip_smoke import (HBM_BYTES_PER_S, adversarial_factors, graph_ms, neumann_bytes,  # noqa: E402
                        rel_err, strayed_laplacian)
from lssp_tpu_torch import _kernels  # noqa: E402
from lssp_tpu_torch.ops import neumann as nm  # noqa: E402
from lssp_tpu_torch.pc.ilu_host import iluk_factor  # noqa: E402


def ptxas_report():
    src = os.path.join(HERE, "lssp_tpu_torch", "csrc", "neumann.cu")
    r = subprocess.run([_kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o", os.devnull, src],
                       capture_output=True, text=True, timeout=600)
    lines = [ln.strip() for ln in r.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(f"ptxas rc {r.returncode}: " + " | ".join(lines))


def check(name, plan, R):
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[R.dtype]
    z = nm.fused_neumann_apply(plan, R)
    ref = nm.neumann_apply_plain(plan, R)
    torch.cuda.synchronize()
    err = rel_err(z, ref)
    same = all(torch.equal(nm.fused_neumann_apply(plan, R), z) for _ in range(5))
    print(f"check {name} {tuple(R.shape)} {str(R.dtype)[6:]}: max rel err {err:.3e}, "
          f"repeats bitwise equal {same}", flush=True)
    if not (err <= tol and same and bool(torch.isfinite(z).all())):
        raise RuntimeError(f"{name}: the kernel disagrees with its plain version")


def timed(tag, plan, R):
    ms = graph_ms(lambda: nm.fused_neumann_apply(plan, R), calls=10, samples=10)
    k = 1 if R.ndim == 1 else R.shape[1]
    nbytes = neumann_bytes(plan, k, R.element_size())
    bound = nbytes / HBM_BYTES_PER_S
    sched, kt, _ = nm.launch_schedule(plan, R, R)
    items = sched.tiles * sched.ncols
    print(f"time {tag} k={k} sweeps={plan.sweeps} {str(R.dtype)[6:]}: {ms * 1e3:.1f} us "
          f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, {bound / (ms * 1e-3):.1%} of the "
          f"{bound * 1e6:.1f} us bound); {sched.rows}-row tiles, kt={kt}, {items} items a "
          f"phase, {sched.grid} blocks, {items / sched.grid:.2f} waves a phase", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("neumann_wavefront_probe: needs a CUDA card")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    ptxas_report()
    rng = np.random.default_rng(0)
    lap64, lap128 = lt.sparse.laplacian_3d(64), lt.sparse.laplacian_3d(128)
    factors = {"ilu0 64^3": iluk_factor(lap64, level=0),
               "ilu0 128^3": iluk_factor(lap128, level=0),
               "iluk(1) 256^2 + 0.5% strays": iluk_factor(strayed_laplacian(lt, np, 256, 0.005),
                                                          level=1),
               "adversarial 128^3": adversarial_factors(lt, np, lap128)}
    plans = {}
    for name, (L, U) in factors.items():
        for dt in (torch.float32, torch.float64):
            plan = nm.plan_fused_neumann(L, U, 6, dtype=dt, device=dev)
            plans[(name, dt)] = plan
            for k in (None, 3, 8):
                shape = plan.n if k is None else (plan.n, k)
                check(name, plan, torch.from_numpy(rng.standard_normal(shape)).to(dev, dt))
    for name in ("ilu0 64^3", "ilu0 128^3", "iluk(1) 256^2 + 0.5% strays"):
        for dt in (torch.float32, torch.float64):
            plan = plans[(name, dt)]
            for k in (None, 8):
                shape = plan.n if k is None else (plan.n, k)
                timed(name, plan, torch.from_numpy(rng.standard_normal(shape)).to(dev, dt))
    L, U = factors["ilu0 128^3"]
    for sweeps in (1, 2, 4, 6):
        plan = nm.plan_fused_neumann(L, U, sweeps, dtype=torch.float32, device=dev)
        for k in (None, 8):
            shape = plan.n if k is None else (plan.n, k)
            R = torch.from_numpy(rng.standard_normal(shape)).to(dev, torch.float32)
            timed("ilu0 128^3", plan, R)


if __name__ == "__main__":
    main()
