"""``lssp_tpu_torch.parallel.multihost`` (one rank per device) against
``tests/test_multihost.py``'s cases for ``lssp_tpu.parallel.multihost``:
the process topology is monkeypatched (``torch.distributed.is_initialized``
/ ``get_rank`` / ``get_world_size`` where JAX's test patches
``jax.process_*``), and ``global_mesh`` runs over a real one-rank gloo
group.  Several real ranks: ``tests/test_torch_dist_ranks.py``."""
import datetime

import jax
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

from lssp_tpu.parallel import multihost as jmultihost
import lssp_tpu_torch as T
from lssp_tpu_torch.parallel import multihost


def topology(monkeypatch, rank, world):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)


class TestInitialize:
    def test_idempotent_when_already_up(self, monkeypatch):
        calls = []
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append(kw))
        multihost.initialize("host0:1234", 4, 1, device="cpu")
        assert calls == []              # already up: must not re-init

    def test_forwards_arguments(self, monkeypatch):
        calls = []
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: calls.append((backend, kw)))
        multihost.initialize("host0:1234", 2, 1, device="cpu")
        assert calls == [("gloo", dict(init_method="tcp://host0:1234", world_size=2, rank=1))]
        timeout = datetime.timedelta(seconds=5)
        multihost.initialize("file:///tmp/rdv", 1, 0, device="cpu", timeout=timeout)
        assert calls[1] == ("gloo", dict(init_method="file:///tmp/rdv", world_size=1, rank=0,
                                         timeout=timeout))

    @pytest.mark.parametrize("device", ["cpu", "cuda"])
    def test_single_process_failure_swallowed(self, monkeypatch, device):
        def boom(*a, **kw):
            raise RuntimeError("no rendezvous in a single-process test env")
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group", boom)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        multihost.initialize(device=device)     # must not raise

    def test_multi_process_failure_raises(self, monkeypatch):
        """ROADMAP C 18: where several processes were asked for, a failed
        rendezvous raises (JAX swallows it)."""
        def boom(*a, **kw):
            raise RuntimeError("rendezvous timed out")
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group", boom)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(RuntimeError, match="timed out"):
            multihost.initialize("host0:1234", num_processes=2, process_id=0, device="cpu")
        monkeypatch.setenv("WORLD_SIZE", "4")
        with pytest.raises(RuntimeError, match="timed out"):
            multihost.initialize(device="cpu")


class TestTopology:
    def test_coordinator_flag(self, monkeypatch):
        assert multihost.is_coordinator()           # no group: one process
        topology(monkeypatch, 0, 4)
        assert multihost.is_coordinator()
        topology(monkeypatch, 3, 4)
        assert not multihost.is_coordinator()

    @pytest.mark.parametrize("n,P", [(100, 4), (101, 4), (7, 8), (10**10, 4)])
    def test_host_local_slices_partition_the_rows(self, monkeypatch, n, P):
        """Slices tile [0, n) exactly, stay exact at 1e10 rows, leave
        trailing ranks empty rather than out of range, and equal JAX's
        under the same (rank, world)."""
        assert multihost.host_local_slice(n) == (0, n)    # no group
        monkeypatch.setattr(jax, "process_count", lambda: P)
        prev_hi = covered = 0
        for p in range(P):
            topology(monkeypatch, p, P)
            monkeypatch.setattr(jax, "process_index", lambda p=p: p)
            lo, hi = multihost.host_local_slice(n)
            assert (lo, hi) == tuple(int(v) for v in jmultihost.host_local_slice(n))
            assert 0 <= lo <= hi <= n
            assert lo == prev_hi        # contiguous, no gaps
            prev_hi = hi
            covered += hi - lo
        assert covered == n

    @pytest.mark.parametrize("world,slots", [(1, 1), (1, 8), (4, 2)])
    def test_global_mesh_spans_every_rank(self, monkeypatch, tmp_path, world, slots):
        multihost.initialize(f"file://{tmp_path / 'rdv'}", 1, 0, device="cpu",
                             timeout=datetime.timedelta(seconds=60))
        try:
            if world > 1:               # the group's topology, seen as rank 1 of 4
                topology(monkeypatch, 1, world)
            mesh = multihost.global_mesh(slots=slots)
            assert mesh.group is not None and mesh.device == torch.device("cpu")
            assert (mesh.rank, mesh.world) == ((1, world) if world > 1 else (0, 1))
            assert mesh.slots == slots and mesh.size == world * slots
            group_less = T.make_mesh(slots, devices=["cpu"] * slots)
            assert mesh != group_less and hash(mesh) != hash(group_less)
        finally:
            monkeypatch.undo()
            dist.destroy_process_group()

    def test_global_mesh_without_a_group(self):
        mesh = multihost.global_mesh(slots=3, device="cpu")
        assert mesh == T.make_mesh(3, devices=["cpu"] * 3) and mesh.group is None
        assert mesh.size == 3 and mesh.world == 1


class TestMultihostSolvePlumbing:
    """Each rank builds its row slice of the system, and the per-rank slices
    reassemble to the full matrix."""

    def test_slices_reassemble(self, monkeypatch):
        A = T.sparse.laplacian_2d(16)
        S = A.to_scipy().tocsr()
        P = 4
        parts = []
        for p in range(P):
            topology(monkeypatch, p, P)
            lo, hi = multihost.host_local_slice(S.shape[0])
            parts.append(S[lo:hi])
        R = sp.vstack(parts).tocsr()
        assert (R != S).nnz == 0
