"""Solver registry (the reference's dispatch switch, lssp.cxx:250-414).

Three tables: the single-rhs solvers (``get_solver``), their per-column
batched forms that ``solve_multi`` runs on an (n, k) block in place of
JAX's ``jax.vmap`` (``get_batched_solver``), and the block-Krylov methods
that share one search block across the columns (``get_block_solver``)."""
from __future__ import annotations

SOLVERS = {}
BATCHED_SOLVERS = {}


def register_solver(*names):
    def deco(fn):
        for n in names:
            SOLVERS[n] = fn
        return fn
    return deco


def register_batched(*names):
    """Register the per-column batched form of the solver of each name."""
    def deco(fn):
        for n in names:
            BATCHED_SOLVERS[n] = fn
        return fn
    return deco


def get_solver(name: str):
    key = name.lower()
    if key not in SOLVERS:
        raise ValueError(f"unknown solver {name!r}; available: {sorted(SOLVERS)}")
    return SOLVERS[key]


def get_batched_solver(name: str):
    """The per-column batched form of a registered solver: (A, B, X0, M,
    opts=) on an (n, k) block, every column on its own single-rhs
    trajectory, SolveInfo fields (k,)."""
    key = name.lower()
    get_solver(key)                     # an unknown name raises the usual error
    if key not in BATCHED_SOLVERS:
        raise ValueError(f"solver {name!r} has no multi-rhs form yet; multi-rhs "
                         f"methods: {sorted(BATCHED_SOLVERS)} and blockcg, blockgmres")
    return BATCHED_SOLVERS[key]


def get_block_solver(name: str):
    """Block-Krylov methods (multi-rhs only: one shared search block, every
    reduction a k×k Gram), or None for the ordinary methods, which
    ``solve_multi`` runs column by column instead.  Signature of a block
    solver: (A, B, X0=None, M=None, opts=None, gram=None)."""
    key = name.lower().replace("_", "")
    if key == "blockcg":
        from lssp_tpu_torch.solvers.block_cg import block_cg
        return block_cg
    if key == "blockgmres":
        from lssp_tpu_torch.solvers.block_gmres import block_gmres
        return block_gmres
    return None


def _populate():
    """Import the solver modules so their @register_solver decorators run
    (JAX's ``registry._populate``)."""
    import importlib
    for mod in ("cg", "gmres", "bicgstab", "bicgstabl", "bicgsafe", "cgs", "gpbicg",
                "cr", "crs", "bicrstab", "bicrsafe", "gpbicr", "qmrcgstab", "tfqmr",
                "orthomin", "idrs", "lgmres", "minres", "fgmres", "bicg", "qmr", "cgnr",
                "lsqr", "pipecg", "direct"):
        importlib.import_module(f"lssp_tpu_torch.solvers.{mod}")


_populate()
