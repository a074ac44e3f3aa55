"""The plain reference: the true relative residual of an answer, in fp64,
on the benchmark's own matrix (``generators.py``) with SciPy.  It imports
nothing of the program and takes nothing the program made but the answer
it judges."""
from __future__ import annotations

import numpy as np


def relres(A, b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """‖b − A·x‖₂ / ‖b‖₂ of each column ((n,) or (n, k) b and x), fp64.
    A non-finite answer, or one of the wrong shape, reads inf."""
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    if x.shape != b.shape:
        return np.full(b.shape[1:] or (1,), np.inf)
    r = b - A @ x
    out = np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)
    return np.where(np.isfinite(out), out, np.inf)
