"""The CUDA-graph apply of ``pc/base.Preconditioner`` on the CPU: what
takes the eager path, which PCs declare ``graph_safe``, the per-instance
graph cache (fresh after ``dataclasses.replace``, bounded LRU by shape,
one graph a stream, its applies held one at a time), the ``applies``
counter and the kernel wrappers' launches a replay counts.  A CPU tensor never replays a graph, so the
cache is driven here through ``_graph_apply`` with ``_capture`` replaced
by a stand-in whose replay reruns the eager apply; the capture itself is
held on the card (``tests/test_torch_cuda.py``)."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import lssp_tpu_torch as lt
from lssp_tpu_torch import _kernels
from lssp_tpu_torch.amg.sa import sa_vcycle
from lssp_tpu_torch.pc import base


def _aniso(n=32):
    return lt.sparse.anisotropic_poisson_2d(n, epsilon=0.01)


def _moved(before):
    return {k: v - before.get(k, 0) for k, v in base.applies.items() if v != before.get(k, 0)}


def _rhs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n,) if k is None else (n, k)))


class _StandIn:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay reruns
    the eager apply from the captured input into the captured output."""

    def __init__(self, M, r_in, z_out):
        self.M, self.r_in, self.z_out = M, r_in, z_out

    def replay(self):
        self.z_out.copy_(self.M.apply_fn(self.M.state, self.r_in))


def _stand_in_capture(self, r):
    r_in = r.clone()
    z_out = self.apply_fn(self.state, r_in)
    return base._Graph(_StandIn(self, r_in, z_out), r_in, z_out)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(base.Preconditioner, "_capture", _stand_in_capture)


@pytest.mark.parametrize("k", [None, 3])
def test_saamg_on_cpu_tensors_is_the_eager_apply(k):
    """A saamg PC declares its apply graph-safe, but on CPU tensors it
    runs eagerly: bitwise the V-cycle's result, counted ``eager``."""
    A = _aniso()
    M = lt.pc.setup(A, "saamg", device="cpu")
    r = _rhs(A.shape[0], k)
    before = dict(base.applies)
    z = M(r)
    assert M.graph_safe
    assert _moved(before) == {"eager": 1}
    assert torch.equal(z, sa_vcycle(M.state, r))
    assert torch.equal(z, M.apply_fn(M.state, r))
    assert not M._graphs


@pytest.mark.parametrize("pc", ["ilu0", "jacobi", "user", "none", "amg", "rsamg"])
def test_other_pcs_never_capture_or_replay(pc):
    """Only saamg declares its apply graph-safe: every other PC counts
    each apply ``eager``, never ``capture`` or ``replay``."""
    A = _aniso(16)
    opts = lt.PCOptions(user_apply=lambda state, r: 0.5 * r) if pc == "user" else None
    M = lt.pc.setup(A, pc, opts, device="cpu")
    r = _rhs(A.shape[0], None)
    before = dict(base.applies)
    for _ in range(3):
        M(r)
    assert not M.graph_safe
    assert _moved(before) == {"eager": 3}


def test_replace_gives_an_empty_graph_cache(stand_in):
    """``dataclasses.replace`` (the bf16 ``cast_state`` path) builds an
    instance with a cache of its own, empty, and keeps ``graph_safe``."""
    A = _aniso()
    M = lt.pc.setup(A, "saamg", device="cpu")
    M._graph_apply(_rhs(A.shape[0], None), 0)
    assert len(M._graphs) == 1
    M16 = dataclasses.replace(M, state=base.cast_state(M.state, torch.bfloat16))
    assert M16.graph_safe and not M16._graphs and M16._graphs is not M._graphs
    assert len(M._graphs) == 1
    Mb = lt.pc.setup(A, "saamg", device="cpu", dtype=torch.bfloat16)
    assert Mb.graph_safe and not Mb._graphs
    assert Mb.state.levels[0].dinv.dtype == torch.bfloat16


def test_graph_cache_evicts_the_least_recently_used_shape(stand_in):
    """One graph a shape, at most ``GRAPH_SHAPES`` of them: a replay moves
    its shape to the back, a new shape past the bound pushes out the
    least recently used one.  Each apply returns a tensor of its own,
    bitwise the eager apply's."""
    A = _aniso()
    n = A.shape[0]
    M = lt.pc.setup(A, "saamg", device="cpu")
    ks = [None, 1, 2, 3]
    assert base.GRAPH_SHAPES == len(ks)
    before = dict(base.applies)
    for k in ks:
        M._graph_apply(_rhs(n, k, seed=1), 0)
    r0 = _rhs(n, None, seed=2)
    z0 = M._graph_apply(r0, 0)                   # a replay: (n,) moves to the back
    z1 = M._graph_apply(_rhs(n, None, seed=3), 0)
    M._graph_apply(_rhs(n, 4, seed=4), 0)        # a fifth shape: (n, 1) goes
    assert _moved(before) == {"capture": 5, "replay": 2}
    shapes = [key[0] for key in M._graphs]
    assert shapes == [(n, 2), (n, 3), (n,), (n, 4)]
    assert torch.equal(z0, M.apply_fn(M.state, r0))
    assert z0.data_ptr() != z1.data_ptr()
    M._graph_apply(_rhs(n, 1, seed=5), 0)
    assert (n, 2) not in [key[0] for key in M._graphs]
    assert base.applies["capture"] - before.get("capture", 0) == 6


def test_each_stream_gets_a_graph_of_its_own(stand_in):
    """One shape applied on two streams: two graphs, so one stream's copy
    in never lands in the buffer the other stream's replay reads."""
    A = _aniso()
    n = A.shape[0]
    M = lt.pc.setup(A, "saamg", device="cpu")
    before = dict(base.applies)
    for stream in (1, 2, 1, 2):
        r = _rhs(n, None, seed=stream)
        assert torch.equal(M._graph_apply(r, stream), M.apply_fn(M.state, r))
    assert _moved(before) == {"capture": 2, "replay": 2}
    assert [key[3] for key in M._graphs] == [1, 2]
    assert M._graphs[((n,), r.dtype, r.device, 1)] is not M._graphs[((n,), r.dtype, r.device, 2)]


def test_threads_sharing_one_graph_get_their_own_answers(stand_in):
    """Four threads apply one instance on one stream, each its own r: the
    lock holds each copy in, replay and copy out together, so every
    thread gets the eager apply of its own r."""
    A = _aniso(16)
    n = A.shape[0]
    M = lt.pc.setup(A, "saamg", device="cpu")
    M._graph_apply(_rhs(n, None), 0)
    rs = [_rhs(n, None, seed=10 + t) for t in range(4)]
    wrong = []

    def work(r):
        want = M.apply_fn(M.state, r)
        for _ in range(25):
            if not torch.equal(M._graph_apply(r, 0), want):
                wrong.append(1)
    threads = [threading.Thread(target=work, args=(r,)) for r in rs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not wrong and len(M._graphs) == 1


class _Counter:
    """A kernel wrapper's launch counts (``dia_spmv.launches`` and so on)."""

    def __init__(self):
        self.launches, self.by_dtype, self.by_route = 0, {}, {}


def test_a_capture_records_launches_and_each_replay_counts_them():
    """Inside ``_kernels.recording`` a wrapper's launch is kept, not
    counted; each ``replayed`` then counts what was kept once, by dtype
    and by route, and a launch outside counts as before."""
    k1, k2 = _Counter(), _Counter()
    with _kernels.recording() as recorded:
        for _ in range(3):
            _kernels.launched(k1, "f32", "ring")
        _kernels.launched(k2, "f64")
    assert (k1.launches, k2.launches) == (0, 0)
    for _ in range(4):
        _kernels.replayed(recorded)
    assert (k1.launches, k1.by_dtype, k1.by_route) == (12, {"f32": 12}, {"ring": 12})
    assert (k2.launches, k2.by_dtype, k2.by_route) == (4, {"f64": 4}, {})
    _kernels.launched(k1, "bf16", "rowwise")
    assert (k1.launches, k1.by_dtype["bf16"], k1.by_route["rowwise"]) == (13, 1, 1)
    assert _kernels._recorded.get() is None


def test_a_replay_counts_the_launches_its_capture_recorded(stand_in, monkeypatch):
    """``_graph_apply`` counts the launches its ``_Graph`` holds on every
    apply, the capturing one included (its capture launched nothing)."""
    k1 = _Counter()

    def capture(self, r):
        g = _stand_in_capture(self, r)
        g.launches[(k1, "f32", "ring")] = 5
        return g
    monkeypatch.setattr(base.Preconditioner, "_capture", capture)
    A = _aniso(16)
    M = lt.pc.setup(A, "saamg", device="cpu")
    for seed in range(3):
        M._graph_apply(_rhs(A.shape[0], None, seed=seed), 0)
    assert (k1.launches, k1.by_dtype, k1.by_route) == (15, {"f32": 15}, {"ring": 15})
