"""Process start to the first timed request: imports, the CUDA context,
the kernel library, the matrix, prepare_ir (or the distributed build)
and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
