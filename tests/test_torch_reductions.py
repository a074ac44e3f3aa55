"""The port's reductions on the CPU do not depend on torch's thread count.

Every inner product and norm of ``lssp_tpu_torch`` goes through
``solvers/base.dot``, which on the CPU sums in an order of its own (numpy's
pairwise order, one contiguous row per column).  The CPU BLAS behind
``torch.dot`` splits a sum by thread count, and BiCGSTAB-type methods turn
that change of rounding into a change of count (bicgstab+none@100 took
124-129 iterations at 1-8 threads before).  Here the three ratchet keys
that moved, and one per-column batched solve, run at 1, 2, 4 and 8
threads: every run must give the same count and a bitwise-equal x.
"""
import numpy as np
import pytest
import torch

import lssp_tpu_torch as T
from lssp_tpu_torch.solvers.base import dot, norm

THREADS = (1, 2, 4, 8)
KEYS = [("bicgstab", 100), ("qmrcgstab", 100), ("gpbicg", 32)]


@pytest.fixture
def restore_threads():
    t = torch.get_num_threads()
    yield
    torch.set_num_threads(t)


def _at_threads(run):
    out = []
    for t in THREADS:
        torch.set_num_threads(t)
        out.append(run())
    return out


@pytest.mark.parametrize("method,N", KEYS, ids=[f"{m}+none@{N}" for m, N in KEYS])
def test_solve_independent_of_thread_count(method, N, restore_threads):
    A = T.sparse.laplacian_2d(N)

    def run():
        x, info = T.solve(A, torch.ones(N * N, dtype=torch.float64), method=method, pc="none",
                          options=T.SolverOptions(restart=60, maxit=3000))
        return info.nits, x
    runs = _at_threads(run)
    assert all(r[0] == runs[0][0] for r in runs), [r[0] for r in runs]
    assert all(torch.equal(r[1], runs[0][1]) for r in runs)


def test_batched_solve_independent_of_thread_count(restore_threads):
    A = T.sparse.laplacian_2d(24)
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((576, 3)))

    def run():
        X, info = T.solve_multi(A, B, method="bicgstab", pc="none",
                                options=T.SolverOptions(maxit=2000))
        return info.nits, X
    runs = _at_threads(run)
    assert all(np.array_equal(r[0], runs[0][0]) for r in runs), [r[0] for r in runs]
    assert all(torch.equal(r[1], runs[0][1]) for r in runs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dot_is_bitwise_per_column(dtype, restore_threads):
    """A block's column sums as the vector does, at every thread count, and
    each sum is within 1e-5 (fp32) / 1e-13 (fp64) of Σ|x·y| of the exact one."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((100_003, 4))).to(dtype)
    Y = torch.from_numpy(rng.standard_normal((100_003, 4))).to(dtype)
    runs = _at_threads(lambda: (dot(X, Y), norm(X[:, 1])))
    for d, n1 in runs:
        assert torch.equal(d, runs[0][0]) and torch.equal(n1, runs[0][1])
        for c in range(4):
            assert torch.equal(dot(X[:, c].contiguous(), Y[:, c].contiguous()), d[c])
    prods = X.double() * Y.double()
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    err = (runs[0][0].double() - prods.sum(dim=0)).abs()
    assert torch.all(err <= tol * prods.abs().sum(dim=0)), err
