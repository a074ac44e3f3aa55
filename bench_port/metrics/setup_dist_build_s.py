"""The distributed build's seconds on rank 0: the program's counter
``lssp_tpu_torch.parallel.dist_solve.builds`` (``count``, ``seconds``),
which the harness's reset of the phase ledger leaves.  A run of a
distributed cell builds once, in its first warm-up request; where it built
more often, the mean of its builds.  Nothing is read without that counter
(a program that lacks it)."""
import sys


def read(run):
    mod = sys.modules.get("lssp_tpu_torch.parallel.dist_solve")
    builds = getattr(mod, "builds", None)
    if not builds or not builds.get("count"):
        return None
    return builds["seconds"] / builds["count"]
