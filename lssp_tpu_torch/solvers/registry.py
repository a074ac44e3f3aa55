"""Solver registry (the reference's dispatch switch, lssp.cxx:250-414)."""
from __future__ import annotations

SOLVERS = {}


def register_solver(*names):
    def deco(fn):
        for n in names:
            SOLVERS[n] = fn
        return fn
    return deco


def get_solver(name: str):
    key = name.lower()
    if key not in SOLVERS:
        raise ValueError(f"unknown solver {name!r}; available: {sorted(SOLVERS)}")
    return SOLVERS[key]


def get_block_solver(name: str):
    """Block-Krylov (multi-rhs) methods are not carried yet: always None."""
    return None


def _populate():
    """Import the solver modules so their @register_solver decorators run."""
    from lssp_tpu_torch.solvers import bicgstab, cg, gmres  # noqa: F401


_populate()
