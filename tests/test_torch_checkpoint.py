"""``lssp_tpu_torch.utils.checkpoint`` against JAX's
``tests/test_checkpoint.py`` cases and JAX's ``checkpointed_solve``.

The port writes format version 2: JAX's magic and ``<II`` (version, crc32)
gate, then a JSON tree and the raw array bytes, no pickle.  A version-1
file (JAX's pickle), a bare pickle, and a tree that names anything outside
``lssp_tpu_torch`` are refused; so is saving the ``user`` PC, whose apply
is the caller's code.
"""
import json
import os
import pickle
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.utils.checkpoint import checkpointed_solve as j_ckpt_solve
from lssp_tpu.utils.checkpoint import save_checkpoint as j_save
import lssp_tpu_torch as T
from lssp_tpu_torch import pc as pc_mod
from lssp_tpu_torch.utils.checkpoint import (
    _MAGIC, FORMAT_VERSION, checkpointed_solve, load_checkpoint, save_checkpoint,
)

CPU = dict(device="cpu")


def _ones(n):
    return torch.ones(n, dtype=torch.float64)


@pytest.mark.parametrize("pc,opts,dtype", [
    ("iluk", T.PCOptions(iluk_level=1), None),
    ("ilu0", T.PCOptions(ilu_sweeps=6), None),
    ("saamg", None, None),
    ("lu", None, None),
    ("ilu0", None, torch.bfloat16),
], ids=["iluk", "ilu0-neumann", "saamg", "lu", "ilu0-bf16"])
def test_roundtrip_solution_and_pc(tmp_path, pc, opts, dtype):
    """JAX's test_roundtrip_solution_and_pc: x, the info and an extra come
    back, and the restored PC applies bitwise as the saved one."""
    A = T.sparse.laplacian_2d(16)
    n = A.shape[0]
    M = pc_mod.setup(A, pc, opts, device="cpu", dtype=dtype)
    x, info = T.solve(A, _ones(n), method="cg", M=M if dtype is None else None, **CPU)
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, x=x, M=M, info=info, note="hello", tol0=1.25e-7)
    ck = load_checkpoint(p, device=False)
    assert torch.equal(ck["x"], x) and ck["x"].dtype == torch.float64
    assert ck["note"] == "hello" and ck["tol0"] == 1.25e-7
    assert ck["info"].nits == info.nits and ck["info"].residual == info.residual
    r = torch.linspace(1.0, 2.0, n, dtype=dtype or torch.float64)
    assert torch.equal(ck["M"](r), M(r))
    with open(p, "rb") as f:
        assert f.read(8) == _MAGIC
        assert struct.unpack("<II", f.read(8))[0] == FORMAT_VERSION == 2


def test_load_places_tensors(tmp_path):
    """device=False keeps tensors on the CPU, a device moves them there,
    True is the current CUDA device (raises without one); numpy arrays in
    a tree stay numpy."""
    p = str(tmp_path / "d.ckpt")
    save_checkpoint(p, x=torch.arange(4.0), arr=np.arange(3), bf=torch.ones(2, dtype=torch.bfloat16),
                    dt=(torch.float32, np.dtype(np.int32)), mix={(1, "a"): None, "f": float("nan")})
    ck = load_checkpoint(p, device="cpu")
    assert ck["x"].device.type == "cpu" and isinstance(ck["arr"], np.ndarray)
    assert ck["bf"].dtype == torch.bfloat16 and torch.equal(ck["bf"], torch.ones(2, dtype=torch.bfloat16))
    assert ck["dt"] == (torch.float32, np.dtype(np.int32))
    assert ck["mix"][(1, "a")] is None and np.isnan(ck["mix"]["f"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(p, device=True)


def test_checkpointed_solve_resumes(tmp_path):
    """JAX's test_checkpointed_solve_resumes: 10-iteration rounds to
    convergence, and a resume of the converged run does nothing more."""
    A = T.sparse.laplacian_2d(24)
    b = _ones(A.shape[0])
    p = str(tmp_path / "run.ckpt")
    x, info = checkpointed_solve(A, b, p, every=10, method="cg", pc="iluk", **CPU)
    assert info.converged
    assert np.linalg.norm(b.numpy() - A.to_scipy() @ x.numpy()) < 1e-5
    assert os.path.exists(p)
    x2, _ = checkpointed_solve(A, b, p, every=10, method="cg", pc="iluk", **CPU)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-12)


def test_checkpointed_solve_interrupted(tmp_path):
    """JAX's test_checkpointed_solve_interrupted: two 5-iteration rounds,
    then a resume to convergence; the resumed x equals an uninterrupted
    run's bitwise (x, M and the frozen tol0 restored exactly)."""
    A = T.sparse.laplacian_2d(24)
    b = _ones(A.shape[0])
    p = str(tmp_path / "int.ckpt")
    _, info1 = checkpointed_solve(A, b, p, every=5, method="cg", pc="iluk", max_rounds=2, **CPU)
    assert not info1.converged and info1.nits == 10
    x2, info2 = checkpointed_solve(A, b, p, every=5, method="cg", pc="iluk", **CPU)
    assert info2.converged
    assert np.linalg.norm(b.numpy() - A.to_scipy() @ x2.numpy()) < 1e-5
    x3, info3 = checkpointed_solve(A, b, str(tmp_path / "whole.ckpt"), every=5, method="cg",
                                   pc="iluk", **CPU)
    assert torch.equal(x2, x3) and info3.nits == info2.nits


def test_checkpointed_solve_matches_jax(tmp_path):
    """The same totals as JAX's checkpointed_solve on laplacian_2d(24),
    every=10, cg + ILU(k), and x within 1e-10."""
    Aj, At = J.sparse.laplacian_2d(24), T.sparse.laplacian_2d(24)
    n = At.shape[0]
    xj, ij = j_ckpt_solve(Aj, jnp.ones(n), str(tmp_path / "j.ckpt"), every=10, method="cg",
                          pc="iluk")
    xt, it = checkpointed_solve(At, _ones(n), str(tmp_path / "t.ckpt"), every=10, method="cg",
                                pc="iluk", **CPU)
    assert it.nits == int(ij.nits) and it.converged == bool(ij.converged)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-10


def test_corrupt_checkpoint_rejected(tmp_path):
    """JAX's test_corrupt_checkpoint_rejected: magic, truncation, a flipped
    byte and a bumped version each raise."""
    p = tmp_path / "c.ckpt"
    save_checkpoint(str(p), x=torch.ones(4))
    raw = p.read_bytes()
    (tmp_path / "bad_magic.ckpt").write_bytes(b"NOTACKPT" + raw[8:])
    with pytest.raises(ValueError, match="magic"):
        load_checkpoint(str(tmp_path / "bad_magic.ckpt"), device=False)
    (tmp_path / "trunc.ckpt").write_bytes(raw[:-3])
    with pytest.raises(ValueError, match="integrity"):
        load_checkpoint(str(tmp_path / "trunc.ckpt"), device=False)
    flipped = bytearray(raw)
    flipped[-1] ^= 0xFF
    (tmp_path / "flip.ckpt").write_bytes(bytes(flipped))
    with pytest.raises(ValueError, match="integrity"):
        load_checkpoint(str(tmp_path / "flip.ckpt"), device=False)
    bumped = bytearray(raw)
    bumped[len(_MAGIC)] = 99
    (tmp_path / "ver.ckpt").write_bytes(bytes(bumped))
    with pytest.raises(ValueError, match="version"):
        load_checkpoint(str(tmp_path / "ver.ckpt"), device=False)


def test_pickles_refused(tmp_path):
    """A version-1 file (JAX's, a pickle behind the gate) and a bare pickle
    (JAX's pre-v1 format) are refused: the port does not unpickle."""
    v1 = str(tmp_path / "v1.ckpt")
    j_save(v1, x=jnp.ones(4))
    with pytest.raises(ValueError, match="does not unpickle"):
        load_checkpoint(v1, device=False)
    bare = tmp_path / "bare.ckpt"
    with open(bare, "wb") as f:
        pickle.dump({"x": np.ones(4), "M": None, "info": None, "extra": {}}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(ValueError, match="does not unpickle"):
        load_checkpoint(str(bare), device=False)


def _forge(path, tree):
    head = json.dumps(tree).encode()
    body = struct.pack("<Q", len(head)) + head
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<II", FORMAT_VERSION, zlib.crc32(body)) + body)


@pytest.mark.parametrize("node", [
    {"function": "os:system"},
    {"function": "lssp_tpu_torch.pc.base:Preconditioner"},
    {"dataclass": "builtins:dict", "fields": {}},
    {"dataclass": "lssp_tpu_torch.pc.base:setup", "fields": {}},
    {"function": "lssp_tpu_torch.solvers.facade:Solver.solve"},
], ids=["outside", "class-as-function", "builtin", "function-as-dataclass", "method"])
def test_foreign_names_refused(tmp_path, node):
    """A well-formed file whose tree names anything but a module-level
    function or dataclass of lssp_tpu_torch is refused at load."""
    p = str(tmp_path / "f.ckpt")
    _forge(p, {"dict": [["x", node]]})
    with pytest.raises(ValueError, match="checkpoint"):
        load_checkpoint(p, device=False)


def test_user_pc_refused_at_save(tmp_path):
    A = T.sparse.laplacian_2d(8)
    M = pc_mod.setup(A, "user", T.PCOptions(user_apply=lambda s, r: r), device="cpu")
    with pytest.raises(ValueError, match="user"):
        save_checkpoint(str(tmp_path / "u.ckpt"), M=M)
    assert not os.path.exists(tmp_path / "u.ckpt")
