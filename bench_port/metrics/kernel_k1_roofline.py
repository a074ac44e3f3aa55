"""K1 (``dia_spmv_kernel``, one rhs) against its HBM roofline, in %."""
from bench_port import roofline


def read(run):
    return roofline.kernel_share(run, "dia_spmv_kernel",
                                 lambda m, k, s: roofline.k1_bytes(m["n"], m["nd"], s))
