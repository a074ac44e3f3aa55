"""Collective calls of the communicator (all-gathers, all-to-alls and
halo P2P exchanges, ``parallel/dist_ops.collectives``) over the window on
rank 0, over the window's inner iterations."""


def read(run):
    if run.collectives is None:
        return None
    its = run.its()
    return sum(run.collectives.values()) / its if its else None
