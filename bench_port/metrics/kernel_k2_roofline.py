"""K2 (``neumann_wavefront_kernel``, the ILU(0) apply, one rhs) against
its HBM roofline, in %."""
from bench_port import roofline


def read(run):
    if run.columns != 1:
        return None
    return roofline.kernel_share(
        run, "neumann_wavefront_kernel",
        lambda m, k, s: roofline.k2_bytes(m["n"], m["nd_lower"], m["nd_upper"], s))
