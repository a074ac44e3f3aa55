"""K4 (``dia_spmv_ext_kernel``, the per-shard DIA product of the
distributed solve, one rhs) against its HBM roofline, in %, on rank 0.

A K4 launch is the operator's product (every band of the matrix) or one
Neumann sweep of the block-Jacobi ILU (one factor's bands), in fp32 or
fp64, and the trace tells only the element size.  So each traced launch
of element size s is given the mean least bytes of the launches of that
size that the program counted by shape over the run
(``lssp_tpu_torch.ops.dia_spmv_ext.dia_spmv_ext.by_shape``, keyed
(ndiag, lo, hi, R, P, s)), one launch's least bytes being

    P·(nd·R + (R + lo + hi) + R)·s

each shard's bands, its extended x and its y once (``PERF.md``'s kernel
table).  Nothing is read without that counter (a program that lacks it)
or without a card."""
import sys

from bench_port import roofline

KERNEL = "dia_spmv_ext_kernel"


def least_bytes(nd, lo, hi, R, P, s):
    return P * (nd * R + (R + lo + hi) + R) * s


def mean_bytes(by_shape) -> dict:
    """{element bytes: the mean least bytes of a launch of that size}."""
    total, count = {}, {}
    for shape, c in by_shape.items():
        s = shape[5]
        total[s] = total.get(s, 0) + least_bytes(*shape[:6]) * c
        count[s] = count.get(s, 0) + c
    return {s: total[s] / count[s] for s in total if count[s]}


def read(run):
    mod = sys.modules.get("lssp_tpu_torch.ops.dia_spmv_ext")
    by_shape = getattr(getattr(mod, "dia_spmv_ext", None), "by_shape", None)
    if not by_shape or not run.profiles:
        return None
    mean = mean_bytes(by_shape)
    launches = run.profiles[0].kernel_launches(KERNEL)
    if any(s not in mean for s, _ in launches):
        return None
    return roofline.share(launches, lambda s: mean[s], roofline.PEAK_BYTES_PER_S.get(run.card))
