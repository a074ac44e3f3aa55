"""Memory observability (``lssp_tpu/utils/memory.py``; the reference's
lssp_mem_cur / peak via getrusage RSS, reference src/utils.cxx:
68-91): host RSS, and the CUDA caching allocator's view of each card."""
from __future__ import annotations

import resource

import torch


def host_memory_mb() -> tuple:
    """(current_rss_mb, peak_rss_mb) of this process."""
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cur_kb = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    cur_kb = int(line.split()[1])
                    break
    except OSError:
        cur_kb = peak_kb
    return cur_kb / 1024.0, peak_kb / 1024.0


def device_memory_mb() -> dict:
    """Per CUDA device, JAX's keys: ``in_use_mb`` (tensors allocated now,
    ``torch.cuda.memory_allocated``), ``peak_mb``
    (``max_memory_allocated``) and ``limit_mb`` (the card's total memory,
    ``mem_get_info``).  With no CUDA device: ``{"cpu": {}}``."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for i in range(torch.cuda.device_count()):
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {"in_use_mb": torch.cuda.memory_allocated(i) / 2**20,
                            "peak_mb": torch.cuda.max_memory_allocated(i) / 2**20,
                            "limit_mb": total / 2**20}
    return out
