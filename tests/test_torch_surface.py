"""The public surface of lssp_tpu_torch against lssp_tpu's: every module of
the JAX package has its port module, and every public name a JAX module
defines or exports (its functions and classes, its ``__all__``) is there in
the port's, as are the ``Solver`` methods.  Only these stay without a
counterpart, each for its reason:"""
import importlib
import inspect
import pkgutil

import pytest

import lssp_tpu
import lssp_tpu_torch

EXCLUDED_MODULES = {
    # the Pallas kernels; their CUDA counterparts are csrc/*.cu (K1-K4)
    ".ops.pallas_spmv": "TPU kernels, ported as csrc/dia_spmv.cu, hyb_spmv.cu, dia_spmv_ext.cu",
    ".ops.pallas_neumann": "TPU kernel, ported as csrc/neumann.cu",
    # one rank per device needs the multi-process communicator
    ".parallel.multihost": "waits for the multi-process communicator (ROADMAP A 4)",
}
EXCLUDED_NAMES = {
    (".ops.spmv", "dia_pallas_ok"): "the TPU gate of the Pallas kernels; no gate on CUDA",
    (".ops.spmv", "lane_gather"): "a TPU gather layout for the Pallas HYB kernels",
    (".parallel", "multihost"): "the module above",
}


def _modules(pkg):
    out = {"": pkg}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".examples" in m.name:
            continue
        out[m.name[len(pkg.__name__):]] = importlib.import_module(m.name)
    return out


def _public(mod):
    names = set(getattr(mod, "__all__", ()))
    for k, v in vars(mod).items():
        if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v)) \
                and getattr(v, "__module__", "") == mod.__name__:
            names.add(k)
    return names


JAX_MODULES = _modules(lssp_tpu)
PORT_MODULES = _modules(lssp_tpu_torch)


@pytest.mark.parametrize("name", sorted(JAX_MODULES), ids=lambda n: n or "<top>")
def test_every_public_name_has_its_counterpart(name):
    if name in EXCLUDED_MODULES:
        assert name not in PORT_MODULES
        return
    assert name in PORT_MODULES, f"lssp_tpu{name} has no lssp_tpu_torch{name}"
    missing = {n for n in _public(JAX_MODULES[name]) - set(dir(PORT_MODULES[name]))
               if (name, n) not in EXCLUDED_NAMES}
    assert not missing, f"lssp_tpu_torch{name} lacks {sorted(missing)}"


def test_solver_methods():
    from lssp_tpu.solvers.facade import Solver as JSolver
    from lssp_tpu_torch.solvers.facade import Solver as TSolver
    missing = [n for n in dir(JSolver) if not n.startswith("_") and not hasattr(TSolver, n)]
    assert not missing


def test_exclusions_are_current():
    """Each excluded name is still absent from the port and present in JAX:
    a name ported later leaves the list."""
    for (mod, n), why in EXCLUDED_NAMES.items():
        assert hasattr(JAX_MODULES[mod], n) and not hasattr(PORT_MODULES[mod], n), why
