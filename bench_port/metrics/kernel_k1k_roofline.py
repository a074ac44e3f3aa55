"""K1k (``dia_spmm_kernel``, k rhs) against its HBM roofline, in %."""
from bench_port import roofline


def read(run):
    return roofline.kernel_share(run, "dia_spmm_kernel",
                                 lambda m, k, s: roofline.k1k_bytes(m["n"], m["nd"], k, s))
