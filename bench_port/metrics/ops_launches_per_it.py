"""Device operations (kernels, copies, sets) in the traced stretch over
the inner iterations of the requests it covered."""


def read(run):
    if not run.profiles or not run.profiled or not run.profiles[0].launches():
        return None
    its = run.its(run.profiled)
    return run.profiles[0].launches() / its if its else None
