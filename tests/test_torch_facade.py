"""The port's facade (``Solver``, ``validate_system``, the prepared-matrix
memo) and ``solve_ir`` against lssp_tpu on the CPU, plus the reference
example: GMRES(60) + ILU(1) on the 2-D Laplacian at N=100 takes 49
iterations to residual 8.18e-6 (tests/golden/laplacian100.jsonl)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lssp_tpu as J
import lssp_tpu_torch as T


def _ones(n, dtype=torch.float64):
    return torch.ones(n, dtype=dtype)


def test_solver_setters_and_reset_rhs():
    A = T.sparse.laplacian_2d(16)
    s = T.Solver("cg", "iluk")
    out = (s.set_rtol(1e-9).set_atol(0.0).set_rbtol(0.0).set_maxit(500).set_restart(30)
           .set_augk(2).set_bgsl(3).set_idrs(5))
    assert out is s
    o = s.options
    assert (o.rtol, o.atol, o.rbtol, o.maxit, o.restart, o.aug_k, o.bgsl, o.idrs) == \
        (1e-9, 0.0, 0.0, 500, 30, 2, 3, 5)
    assert s.nits is None and s.residual is None
    with pytest.raises(RuntimeError, match="assemble"):
        s.solve()
    s.assemble(A, _ones(256))
    x1 = s.solve()
    S = A.to_scipy()
    assert np.linalg.norm(1 - S @ x1.numpy()) <= 1e-9 * 16 * 1.01
    assert s.nits > 0 and s.residual == s.info.residual
    b2 = torch.from_numpy(np.random.default_rng(0).standard_normal(256))
    M_before = s.M
    x2 = s.reset_rhs(b2).reset_unknown(torch.zeros(256)).solve()
    assert s.M is M_before                              # factorization kept
    assert np.linalg.norm(b2.numpy() - S @ x2.numpy()) <= 1e-9 * np.linalg.norm(b2.numpy()) * 1.01
    # warm start from x2, which already meets ||r|| <= 1e-9 ||b2||
    s.set_rbtol(1e-9).solve()
    assert s.nits == 0 and s.info.converged


def test_validate_system_errors():
    A = T.CSR.from_scipy(sp.random(10, 8, density=0.5, random_state=0).tocsr())
    with pytest.raises(ValueError, match="SQUARE"):
        T.solve(A, _ones(10), method="cg")
    with pytest.raises(ValueError, match="SQUARE"):
        T.solve_ir(A, _ones(10), method="gmres")
    with pytest.raises(ValueError, match="rhs length"):
        T.solve(T.sparse.laplacian_2d(8), _ones(63), method="cg")
    with pytest.raises(ValueError, match="1-D"):
        T.solve(T.sparse.laplacian_2d(8), torch.tensor(1.0), method="cg")
    with pytest.raises(ValueError, match="unknown reorder"):
        T.solve(T.sparse.laplacian_2d(8), _ones(64), method="cg", reorder="hier:4:64")
    with pytest.raises(ValueError, match="unknown reorder"):
        T.solve(T.sparse.laplacian_2d(8), _ones(64), method="cg", reorder="amd")
    b = T.solvers.validate_system(T.sparse.laplacian_2d(8), np.ones(64, np.int32), "cg")
    assert b.dtype == torch.float64
    # the AMG ordering mode is accepted (the grid keeps the ordering here)
    x, info = T.solve(T.sparse.laplacian_2d(8), _ones(64), method="cg", reorder="hier:4:64:12")
    assert info.converged
    x, info = T.solve(T.sparse.laplacian_2d(8), torch.ones(64, dtype=torch.int32), method="cg")
    assert info.converged and x.dtype == torch.float64


def test_prepared_matrix_memo():
    A = T.sparse.laplacian_2d(10)
    T.solve(A, _ones(100), method="cg")
    key = ("prepared", "auto", "cpu")
    D = A._prepared_cache[key][1]
    T.solve(A, _ones(100), method="gmres")
    assert A._prepared_cache[key][1] is D                     # reused
    T.solve(A, _ones(100), method="cg", reorder=None)         # None means "auto"
    assert A._prepared_cache[key][1] is D
    assert ("prepared", None, "cpu") not in A._prepared_cache
    A64 = T.prepare_ir(A, pc="none", device="cpu")[1]
    assert T.prepare_ir(A, pc="none", reorder=None, device="cpu")[1] is A64
    T.solve(A, _ones(100), method="gmres", reorder="rcm")     # its own entry
    assert A._prepared_cache[key][1] is D
    assert ("prepared", "rcm", "cpu") in A._prepared_cache
    A.data[0] += 1.0                                          # in-place change
    T.solve(A, _ones(100), method="cg")
    assert A._prepared_cache[key][1] is not D


def test_fp32_rhs_promotes_and_coo_input():
    A = T.sparse.laplacian_2d(12)
    coo = T.COO(np.repeat(np.arange(144), np.diff(A.indptr)).astype(np.int32),
                A.indices, A.data, A.shape)
    x, info = T.solve(coo, _ones(144, torch.float32), method="bicgstab", pc="ilu0")
    assert x.dtype == torch.float64 and info.converged
    assert np.linalg.norm(1 - A.to_scipy() @ x.numpy()) <= 1e-7 * 12 * 1.01


@pytest.mark.parametrize("method", ["cg", "gmres"])
def test_solve_ir_matches_jax(method):
    """fp32 inner (6 Neumann sweeps, the TPU default) in an fp64 outer loop,
    on the 3-D Poisson 16³: inner iteration totals within ±1 of JAX's."""
    Aj, At = J.sparse.laplacian_3d(16), T.sparse.laplacian_3d(16)
    o = dict(rtol=1e-8, atol=0.0, rbtol=0.0, maxit=2000)
    xj, ij = J.solve_ir(Aj, jnp.ones(4096), method=method, pc="ilu0",
                        options=J.SolverOptions(**o), pc_options=J.PCOptions(ilu_sweeps=6))
    xt, it = T.solve_ir(At, _ones(4096), method=method, pc="ilu0",
                        options=T.SolverOptions(**o), pc_options=T.PCOptions(ilu_sweeps=6))
    assert abs(it.nits - int(ij.nits)) <= 1
    assert it.converged and xt.dtype == torch.float64
    relres = np.linalg.norm(1 - At.to_scipy() @ xt.numpy()) / np.sqrt(4096)
    assert relres <= 1e-8
    # the inner preconditioner is the fp32 K2 plan, memoized on the container
    _, A64, A32, perm, M32 = T.prepare_ir(At, method=method, pc="ilu0",
                                          pc_options=T.PCOptions(ilu_sweeps=6), device="cpu")
    assert perm is None
    assert A64.dtype == torch.float64 and A32.dtype == torch.float32
    assert M32.name == "ilu0-fn6" and M32.state.dtype == torch.float32


def test_exam_reference_example():
    A = T.sparse.laplacian_2d(100)
    s = T.Solver("gmres", "iluk", pc_options=T.PCOptions(ilu_sweeps=0))
    s.set_restart(60).set_maxit(3000)
    s.assemble(A, _ones(10000))
    x = s.solve()
    ver = np.linalg.norm(1 - A.to_scipy() @ x.numpy())
    assert s.nits == 49
    assert ver <= 2 * 8.18e-6 and abs(s.residual - 8.1805878e-06) <= 1e-11


def test_entry_points_default_to_the_card(monkeypatch):
    """Host data without ``device`` targets CUDA; with no GPU that raises
    (never a quiet CPU run) and ``device="cpu"`` solves."""
    from lssp_tpu_torch.amg.rs import setup_rs_pc
    from lssp_tpu_torch.amg.sa import setup_saamg_pc
    from lssp_tpu_torch.config import resolve_device
    A = T.sparse.laplacian_2d(8)
    b = np.ones(64)
    opts = T.PCOptions().resolved()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T.solve(A, b, method="cg"),
                 lambda: T.solve_ir(A, b, method="cg"),
                 lambda: T.solve_multi(A, np.ones((64, 2)), method="cg"),
                 lambda: T.solve_ir_multi(A, np.ones((64, 2)), method="blockcg"),
                 lambda: T.prepare_ir(A, method="cg"),
                 lambda: T.Solver("cg").assemble(A, b),
                 lambda: T.amg_solve(A, b),
                 lambda: T.make_mesh(),
                 lambda: T.pc.setup(A, "jacobi"),
                 lambda: T.amg.sa_setup(A),
                 lambda: T.amg.build_device_amg(T.amg.amg_setup(A)),
                 lambda: T.amg.build_device_rs(T.amg.rs_host_setup(A)),
                 lambda: setup_saamg_pc(A, opts),
                 lambda: setup_rs_pc(A, opts)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    x, info = T.solve(A, b, method="cg", device="cpu")
    assert info.converged and x.device.type == "cpu"
    x = T.Solver("cg", device="cpu").assemble(A, b).solve()
    assert x.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None, b) == torch.device("cuda", 0)
    assert resolve_device(None, torch.ones(3)) == torch.device("cpu")
    assert resolve_device("cpu", b) == torch.device("cpu")


def test_one_card_has_one_name(monkeypatch):
    """An index-less "cuda" resolves to the current card's index, so
    ``device="cuda"`` and host data (the default) key the prepared-matrix
    memos alike, and a mesh of "cuda" and "cuda:0" slots is one device."""
    from lssp_tpu_torch.config import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    explicit, default = resolve_device("cuda"), resolve_device(None, np.ones(4))
    assert explicit == default == torch.device("cuda", 0)
    assert str(explicit) == str(default) == "cuda:0"
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    mesh = T.make_mesh(devices=["cuda", "cuda:0", torch.device("cuda")])
    assert mesh.size == 3 and set(mesh.devices) == {torch.device("cuda", 0)}
    assert T.parallel.Mesh((torch.device("cuda"),)) == T.parallel.Mesh((torch.device("cuda:0"),))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        T.make_mesh(devices=["cuda", "cuda:1"])
