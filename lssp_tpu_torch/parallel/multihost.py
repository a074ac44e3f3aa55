"""Multi-process runtime helpers: one process (rank) per device.

The JAX package brings up ``jax.distributed`` and runs one program on every
host over a global device mesh (``lssp_tpu/parallel/multihost.py``).  Here
each rank drives one device through a ``torch.distributed`` process group,
NCCL on the card and gloo on the CPU, and ``global_mesh`` gives the
distributed solvers a ``Mesh`` over every rank.  Under ``torchrun
--nproc-per-node=N`` every process calls ``initialize()`` and
``global_mesh(slots=...)``, then the same ``dist_solve*`` with the whole
system and right-hand side; each returns the whole x.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from lssp_tpu_torch.config import resolve_device
from lssp_tpu_torch.parallel.dist_solve import Mesh


def _many_asked(num_processes) -> bool:
    """Whether the caller or the launcher's environment asked for more than
    one process."""
    if num_processes is not None and int(num_processes) > 1:
        return True
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, timeout: Optional[datetime.timedelta] = None) -> None:
    """Bring up the process group (idempotent: nothing to do when one is up).

    ``device``: the rank's device type; NCCL for CUDA (the default), gloo
    for ``"cpu"``.  The rendezvous is ``tcp://{coordinator_address}`` (an
    address that names its scheme, such as ``file://...``, is taken as
    it is) with ``num_processes`` ranks, this one ``process_id``; with no
    address, torchrun's environment (``env://``).  A CUDA rank is bound to
    ``cuda:{LOCAL_RANK}``, else ``cuda:{process_id % device_count}``.
    A failure is swallowed where no multi-process run was asked for (no
    ``num_processes`` > 1 and no ``WORLD_SIZE`` > 1 in the environment), as
    in one process there is nothing to bring up; where one was asked for it
    raises (JAX swallows that case too: ROADMAP C 18)."""
    if dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = (coordinator_address if "://" in coordinator_address
                             else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if timeout is not None:
        kw["timeout"] = timeout
    try:
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("initialize: no CUDA device for an NCCL rank; pass "
                                   "device=\"cpu\" for gloo ranks on the CPU")
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else int(process_id or 0)
            torch.cuda.set_device(index % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    except (RuntimeError, ValueError):
        if _many_asked(num_processes):
            raise


def global_mesh(axis: str = "shard", slots: int = 1, device=None) -> Mesh:
    """A ``Mesh`` over every rank, with ``slots`` shards on this rank's
    device (``world × slots`` shards in all).  ``axis`` is kept for the
    signature of JAX's ``global_mesh``.  The device is the group's: the
    current CUDA device under NCCL, the CPU under gloo; with no group up, a
    one-process mesh on ``device`` (the card by default)."""
    if not dist.is_initialized():
        return Mesh((resolve_device(device),) * slots)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh((torch.device(device),) * slots, group=dist.group.WORLD)


def is_coordinator() -> bool:
    """Rank 0 of the group; True in one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_local_slice(n: int):
    """The [lo, hi) row range this rank owns under an even row partition of
    a global n-row system (Python ints, exact at any n); (0, n) with no
    group."""
    if not dist.is_initialized():
        return 0, n
    p, world = dist.get_rank(), dist.get_world_size()
    per = -(-n // world)
    lo = min(p * per, n)
    return lo, min(lo + per, n)
