"""The port's examples (``lssp_tpu_torch/examples``) on the CPU at small
sizes, against the JAX package on the same problems: ``exam`` against
JAX's ``Solver`` (its fp64 branch of ``examples/exam.py``), ``tour``
section by section against ``scripts/jax_krylov_reference.py``'s
``tour_cells`` for lssp_tpu (JAX's ``examples/tour.py`` at the same
sizes), ``distributed`` against JAX's ``dist_solve`` on its 8-device
mesh.  Counts are held to JAX's ± 2; the bf16 section, a rounding class
(ROADMAP C 10), to JAX's count + 15 % and its residual bound."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.parallel.dist_solve import dist_solve as j_dist_solve, make_mesh as j_mesh
from lssp_tpu_torch.examples import distributed, exam, tour

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "jax_krylov_reference.py")


def _reference():
    spec = importlib.util.spec_from_file_location("jax_krylov_reference", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exam_matches_jax_solver(capsys):
    out = exam.main(["30", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "gmres: total iteration:" in text and "verification, residual:" in text
    A = J.sparse.laplacian_2d(30)
    s = J.Solver(method="gmres", pc="iluk")
    s.set_restart(60).set_maxit(3000)
    s.assemble(A, jnp.ones(A.shape[0]))
    x = s.solve()
    ver = float(np.linalg.norm(1.0 - A.to_scipy() @ np.asarray(x)))
    assert abs(out["nits"] - int(s.info.nits)) <= 1
    assert out["verification"] <= 2 * ver


def test_tour_matches_jax_sections(capsys):
    scale = 0.25
    got = tour.main(["--scale", str(scale), "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("== ") == 11 and "resumed: total nits=" in text
    ref = _reference().tour_cells(J, {}, scale=scale, dist=False)
    assert set(got) == set(ref)
    for cell, (n, _) in got.items():
        if cell in ("lsq", "bf16", "hyb"):
            continue
        rn = ref[cell][0]
        if isinstance(n, list):
            assert all(abs(a - b) <= 2 for a, b in zip(n, rn)), (cell, n, rn)
        elif isinstance(n, bool) or cell == "direct":
            assert n == rn, (cell, n, rn)
        else:
            assert abs(n - rn) <= 2, (cell, n, rn)
    assert got["hyb"][0] == ref["hyb"][0] and got["hyb"][1] == "HYB"
    ns = tour.sizes(scale)["ns"]
    assert got["bf16"][0] <= np.ceil(1.15 * ref["bf16"][0])
    assert got["bf16"][1] <= 1.1e-8 * ns                 # ‖b‖ = ns
    assert got["lsq"][0] <= 10 * max(ref["lsq"][0], 1e-12)


@pytest.fixture(scope="module")
def mesh8():
    return j_mesh(8)


def test_distributed_matches_jax(capsys, mesh8):
    got = distributed.main(["--device", "cpu", "--n", "16"])
    assert capsys.readouterr().out.startswith("mesh: 8 devices (cpu)")
    A = J.sparse.laplacian_2d(16)
    for method, pc in distributed.CASES:
        _, info = j_dist_solve(A, jnp.ones(A.shape[0]), method=method, pc=pc, mesh=mesh8,
                               options=J.SolverOptions(maxit=500))
        n, res, conv = got[f"{method}+{pc}"]
        assert conv and bool(info.converged)
        assert abs(n - int(info.nits)) <= 2, (method, pc, n, int(info.nits))
        assert res <= 1e-4


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (exam, tour, distributed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
