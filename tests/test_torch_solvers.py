"""The port's Krylov solvers against lssp_tpu's ``solve`` on the CPU.

Each config solves the 2-D Laplacian at N=32 (b = 1, x0 = 0, restart 60)
in both packages with ``ilu_sweeps`` pinned.  Iteration counts match
within ±1 (reductions run in another order), x agrees to 1e-8 relative,
and counts stay inside the ``tests/golden/ratchet.json`` limit (recorded +
max(2, 5%)).  cg+ilut is the reference's stall class (unsymmetric PC in CG):
it must stall in both packages.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
import lssp_tpu_torch as T

N = 32
with open(os.path.join(os.path.dirname(__file__), "golden", "ratchet.json")) as f:
    RATCHET = json.load(f)

A_J = J.sparse.laplacian_2d(N)
A_T = T.sparse.laplacian_2d(N)


def _both(method, pc, sweeps, maxit=2000):
    xj, ij = J.solve(A_J, jnp.ones(N * N), method=method, pc=pc,
                     options=J.SolverOptions(restart=60, maxit=maxit),
                     pc_options=J.PCOptions(ilu_sweeps=sweeps))
    xt, it = T.solve(A_T, torch.ones(N * N, dtype=torch.float64), method=method, pc=pc,
                     options=T.SolverOptions(restart=60, maxit=maxit),
                     pc_options=T.PCOptions(ilu_sweeps=sweeps))
    return np.asarray(xj), ij, xt.numpy(), it


CONFIGS = [(m, p, 0) for m in ("cg", "gmres", "rgmres", "bicgstab")
           for p in ("none", "iluk", "ilut") if (m, p) != ("cg", "ilut")]
CONFIGS += [("cg", "iluk", 6), ("gmres", "iluk", 6)]


@pytest.mark.parametrize("method,pc,sweeps", CONFIGS,
                         ids=[f"{m}+{p}-s{s}" for m, p, s in CONFIGS])
def test_matches_jax_solve(method, pc, sweeps):
    xj, ij, xt, it = _both(method, pc, sweeps)
    assert it.converged and bool(ij.converged)
    assert abs(it.nits - int(ij.nits)) <= 1
    assert np.linalg.norm(xt - xj) <= 1e-8 * np.linalg.norm(xj)
    true_res = np.linalg.norm(1.0 - A_T.to_scipy() @ xt)
    assert true_res <= 1.1e-7 * N * 4       # the golden tests' stopping bound
    key = f"{method}+{pc}@{N}"
    if sweeps == 0 and key in RATCHET:
        assert it.nits <= RATCHET[key] + max(2, int(np.ceil(0.05 * RATCHET[key])))


def test_cg_ilut_stalls_in_both():
    xj, ij, xt, it = _both("cg", "ilut", 0, maxit=120)
    assert not it.converged and not bool(ij.converged)
    assert it.nits == int(ij.nits) == 120
    assert np.isfinite(xt).all()


def test_history_and_maxit_cap():
    x, info = T.solve(A_T, torch.ones(N * N, dtype=torch.float64), method="cg",
                      options=T.SolverOptions(maxit=5, record_history=True))
    assert info.nits == 5 and not info.converged
    assert info.history.shape == (6,)                 # maxit + 1
    assert np.isfinite(info.history[:6]).all() and info.history[0] == info.r0norm
    assert info.history[5] == info.residual


def test_warm_start_and_zero_rhs():
    b = torch.ones(N * N, dtype=torch.float64)
    x, info = T.solve(A_T, b, method="bicgstab", pc="iluk")
    x2, info2 = T.solve(A_T, b, x0=x, method="bicgstab", pc="iluk")
    assert info2.nits == 0 and info2.converged
    x3, info3 = T.solve(A_T, torch.zeros_like(b), method="gmres")
    assert info3.nits == 0 and float(x3.abs().max()) == 0.0


def test_unknown_names_list_the_registry():
    with pytest.raises(ValueError, match="available"):
        T.solve(A_T, torch.ones(N * N, dtype=torch.float64), method="nosuch")
    with pytest.raises(ValueError, match="available"):
        T.solve(A_T, torch.ones(N * N, dtype=torch.float64), pc="nosuch")
    assert sorted(T.solvers.SOLVERS) == [
        "bicg", "bicgsafe", "bicgstab", "bicgstabl", "bicrsafe", "bicrstab", "cagmres",
        "cargmres", "cg", "cgn", "cgnr", "cgs", "cr", "crs", "direct", "fgmres", "gmres",
        "gpbicg", "gpbicr", "idrs", "lgmres", "lsqr", "minres", "orthomin", "pipecg", "qmr",
        "qmrcgstab", "rgmres", "rlgmres", "splu", "tfqmr"]
