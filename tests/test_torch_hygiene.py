"""Static and run-time hygiene of lssp_tpu_torch: it never imports JAX or
lssp_tpu, builds nothing at import time, and every annotation resolves
(as tests/test_lint.py checks for lssp_tpu)."""
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys
import typing

import pytest

import lssp_tpu_torch

PKG_DIR = os.path.dirname(lssp_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
MODULES = sorted(info.name for info in
                 pkgutil.walk_packages(lssp_tpu_torch.__path__, "lssp_tpu_torch."))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|lssp_tpu)(\.|\s|$)", re.M)


def test_subprocess_solve_without_jax():
    code = (
        "import sys, torch, lssp_tpu_torch as lt\n"
        "A = lt.sparse.laplacian_2d(12)\n"
        "x, info = lt.solve_ir(A, torch.ones(144, dtype=torch.float64), method='cg',"
        " pc='ilu0', options=lt.SolverOptions(rtol=1e-10, atol=0, rbtol=0), device='cpu')\n"
        "assert info.converged, info\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lssp_tpu' or m.startswith('lssp_tpu.')]\n"
        "assert not bad, bad\n"
        "from lssp_tpu_torch import _kernels\n"
        "assert _kernels._lib is None   # CPU tensors never load the CUDA library\n"
        "print('ok', info.nits)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_no_source_imports_jax_or_lssp_tpu():
    sources = []
    for root, _, files in os.walk(PKG_DIR):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(sources) > 15
    for path in sources:
        with open(path) as f:
            hits = FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_kernels_target_sm_90a():
    from lssp_tpu_torch import _kernels
    assert _kernels.NVCC_FLAGS[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    names = sorted(os.path.basename(s) for s in _kernels._sources())
    assert names == ["dia_spmv.cu", "dia_spmv_ext.cu", "hyb_spmv.cu", "neumann.cu"]


def test_annotation_check_covers_the_amg_slice():
    amg = {"lssp_tpu_torch.amg", "lssp_tpu_torch.amg.setup", "lssp_tpu_torch.amg.cycle",
           "lssp_tpu_torch.amg.sa", "lssp_tpu_torch.amg.rs", "lssp_tpu_torch.amg.aggregate",
           "lssp_tpu_torch.pc.amg", "lssp_tpu_torch.ops.tridiag"}
    assert amg <= set(MODULES)


@pytest.mark.parametrize("modname", MODULES)
def test_annotations_resolve(modname):
    mod = importlib.import_module(modname)
    for obj in vars(mod).values():
        if (inspect.isclass(obj) or inspect.isfunction(obj)) and obj.__module__ == modname:
            typing.get_type_hints(obj, include_extras=True)
