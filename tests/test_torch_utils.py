"""``lssp_tpu_torch.utils`` (log, memo, profile, memory, debug) against
``lssp_tpu.utils`` on the CPU."""
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lssp_tpu as J
from lssp_tpu.utils import memo as jmemo
from lssp_tpu.utils import profile as jprof
from lssp_tpu.utils.log import set_log as j_set_log
import lssp_tpu_torch as T
from lssp_tpu_torch import _kernels
from lssp_tpu_torch.utils import (
    Timer, check_finite, device_memory_mb, get_verbosity, host_memory_mb, log, nan_guard,
    profile, set_log, set_verbosity, warning,
)
from lssp_tpu_torch.utils.memo import fingerprint, memo_get, memo_put

_NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+|\d+\.\d+")


def _masked(text):
    """Lines with every number replaced by a placeholder, and the numbers."""
    lines = [l for l in text.splitlines() if l.strip()]
    return [_NUM.sub("#", l) for l in lines], [[float(v) for v in _NUM.findall(l)]
                                               for l in lines]


def test_solver_trace_equals_jax(capsys):
    """JAX's test_solver_set_log settings (cg + jacobi on laplacian_2d(8),
    verbosity 2): the port prints JAX's stdout line for line, the phase
    times masked, the residuals to 1e-6 (the last, at round-off, to 1e-12
    absolute); set_log tees every line, the trace included."""
    jax.effects_barrier()                   # nothing pending from an earlier test
    capsys.readouterr()
    Aj, At = J.sparse.laplacian_2d(8), T.sparse.laplacian_2d(8)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    sj = J.Solver(method="cg", pc="jacobi", options=J.SolverOptions(verbosity=2))
    sj.set_log(jbuf)
    try:
        sj.assemble(Aj, jnp.ones(64))
        sj.solve()
        jax.effects_barrier()               # JAX's debug prints arrive asynchronously
    finally:
        j_set_log(None)
    jout = capsys.readouterr().out
    st = T.Solver(method="cg", pc="jacobi", options=T.SolverOptions(verbosity=2), device="cpu")
    st.set_log(tbuf)
    try:
        st.assemble(At, torch.ones(64, dtype=torch.float64))
        st.solve()
    finally:
        set_log(None)
    tout = capsys.readouterr().out
    (jl, jv), (tl, tv) = _masked(jout), _masked(tout)
    assert jl == tl and len(tl) == 12
    assert tl[0] == "solver: assemble (matrix conversion): # s"
    assert tl[1] == "pc: assemble (jacobi): # s"
    for a, b in zip(jv[2:], tv[2:]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12)
    assert tbuf.getvalue() == tout                     # the whole trace is tee'd
    assert "assemble" in jbuf.getvalue()


def test_log_levels_tee_and_warning(capsys):
    buf = io.StringIO()
    old = get_verbosity()
    set_log(buf)
    try:
        set_verbosity(1)
        log("shown", level=1)
        log("hidden", level=2)
        warning("careful")
        set_verbosity(0)
        warning("quiet")
    finally:
        set_log(None)
        set_verbosity(old)
    out = capsys.readouterr()
    assert out.out == "shown\n" and out.err == "warning: careful\n"
    assert buf.getvalue() == "shown\nwarning: careful\n"


def test_timer(capsys):
    with Timer("phase x", level=0) as t:
        sum(range(1000))
    assert t.elapsed > 0.0
    assert re.fullmatch(r"phase x: \d+\.\d{6} s\n", capsys.readouterr().out)
    with Timer() as t:
        pass
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("field", ["data", "indices", "indptr"])
def test_fingerprint_sees_inplace_changes(field):
    A = T.sparse.laplacian_2d(6)
    A = type(A)(A.indptr.copy(), A.indices.copy(), A.data.copy(), A.shape)
    fp = fingerprint(A)
    assert fp == fingerprint(A)
    buf = getattr(A, field)
    if field == "indptr":
        buf[3] += 1                                   # a row boundary moves
    elif field == "indices":
        buf[[0, 1]] = buf[[1, 0]]
    else:
        buf[5] += 1.0
    assert fingerprint(A) != fp
    assert fingerprint(object()) is None
    # JAX's fingerprint takes the same buffers
    Aj = J.sparse.CSR(A.indptr, A.indices, A.data, A.shape)
    assert jmemo.fingerprint(Aj)[:3] == fingerprint(A)[:3]


def test_memo_lru_replace_bound_and_none():
    class Box:
        pass
    A = Box()
    for k in "abc":
        memo_put(A, "_c", k, 1, k.upper(), bound=3)
    assert list(A._c) == ["a", "b", "c"]
    assert memo_get(A, "_c", "a", 1) == "A"            # LRU touch: a goes to the back
    assert list(A._c) == ["b", "c", "a"]
    memo_put(A, "_c", "c", 1, "C2", bound=3)            # replace in place: nothing evicted
    assert list(A._c) == ["b", "a", "c"] and A._c["c"] == "C2"
    memo_put(A, "_c", "d", 1, "D", bound=3)             # new: the oldest (b) goes
    assert list(A._c) == ["a", "c", "d"] and "b" not in A._c_fp
    assert memo_get(A, "_c", "a", 2) is None            # stale fingerprint
    memo_put(A, "_c", "n", None, "N")
    assert memo_get(A, "_c", "n", None) is None         # None never matches
    memo_put(1, "_c", "k", 1, "v")                      # no attributes: skipped
    assert memo_get(1, "_c", "k", 1) is None


@pytest.mark.parametrize("pc", ["saamg", "rsamg"])
def test_phase_names_equal_jax(pc):
    jprof.reset_phases()
    profile.reset_phases()
    J.prepare_ir(J.sparse.laplacian_2d(32), method="cg", pc=pc)
    T.prepare_ir(T.sparse.laplacian_2d(32), method="cg", pc=pc, device="cpu")
    assert sorted(profile.phase_times()) == sorted(jprof.phase_times())
    assert sorted(profile.phase_bytes()) == sorted(jprof.phase_bytes())
    assert all(v > 0 for v in profile.phase_bytes().values())
    assert profile.tree_device_bytes(
        {"a": (torch.zeros(3), [np.zeros(2, np.int32)]), "b": None}) == 12 + 8


def test_profile_hooks(tmp_path):
    with profile.trace(str(tmp_path / "tr"), device="cpu"):
        with profile.annotate("region"):
            torch.ones(4).sum()
    assert any(p.suffix == ".json" for p in (tmp_path / "tr").iterdir())
    assert profile.enable_persistent_cache() == _kernels._BUILD_DIR


def test_memory_keys():
    cur, peak = host_memory_mb()
    assert 0 < cur <= peak * 1.01
    dev = device_memory_mb()
    if torch.cuda.is_available():
        assert all(set(v) == {"in_use_mb", "peak_mb", "limit_mb"} for v in dev.values())
    else:
        assert dev == {"cpu": {}}


def test_nan_guard_and_check_finite():
    A = T.sparse.laplacian_2d(8)
    b = torch.ones(64, dtype=torch.float64)
    b[5] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN"):
        with nan_guard():
            T.solve(A, b, method="bicgstab", device="cpu")
    assert not _kernels.nan_check
    x, _ = T.solve(A, torch.ones(64, dtype=torch.float64), method="cg", device="cpu")
    with nan_guard():
        T.solve(A, torch.ones(64, dtype=torch.float64), method="cg", device="cpu")
        _kernels.check_nan("k", x)
        with pytest.raises(FloatingPointError, match="kernel k"):
            _kernels.check_nan("k", b)
    _kernels.check_nan("k", b)                          # off again: no check
    assert check_finite(x, "x") is x
    bad = np.ones(10)
    bad[[7, 3]] = [np.inf, np.nan]
    with pytest.raises(FloatingPointError, match=r"y contains 2 non-finite entries \(first at index 3\)"):
        check_finite(torch.from_numpy(bad), "y")


def test_dist_trace_equals_jax(capsys):
    """The distributed launcher's trace: JAX prints each iteration's line
    once per shard (a debug print inside shard_map); the port prints it
    once, with the same values."""
    from lssp_tpu.parallel.dist_solve import dist_solve as j_dist_solve, make_mesh as j_mesh
    jax.effects_barrier()                   # nothing pending from an earlier test
    capsys.readouterr()
    Aj, At = J.sparse.laplacian_2d(16), T.sparse.laplacian_2d(16)
    j_dist_solve(Aj, jnp.ones(256), method="cg", pc="jacobi", mesh=j_mesh(8),
                 options=J.SolverOptions(verbosity=1))
    jax.effects_barrier()                   # JAX's debug prints arrive asynchronously
    jl, jv = _masked(capsys.readouterr().out)
    T.dist_solve(At, torch.ones(256, dtype=torch.float64), method="cg", pc="jacobi",
                 mesh=T.make_mesh(8, devices=["cpu"] * 8), options=T.SolverOptions(verbosity=1))
    tl, tv = _masked(capsys.readouterr().out)
    assert len(jl) == 8 * len(tl) and jl[::8] == tl
    for a, b in zip(jv[::8], tv):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12)
