"""Reduction of a ``torch.profiler`` trace of the profiled stretch to what
the per-layer metrics read: the device's busy time (the union of its
kernel and copy intervals), the device operations by short kernel name
with each launch's element type, and the idle gaps by the host operation
that was running.

The busy union is ``chip_smoke.profile_solve``'s arithmetic, copied.
"""
from __future__ import annotations

import bisect
import dataclasses

# element type of a port kernel's first template argument -> bytes
ITEMSIZE = {"float": 4, "double": 8, "__nv_bfloat16": 2}


def short_name(name: str) -> str:
    """A kernel's own name, without ``void``, its namespace, template
    arguments and parameters."""
    s = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return s.split("<")[0].split("(")[0].split("::")[-1].strip()


def first_template_arg(name: str) -> str | None:
    """The first template argument of a kernel's full name (its element
    type for the port's kernels), or None."""
    s = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = s.split("(")[0]
    if "<" not in head:
        return None
    return head.split("<", 1)[1].split(",")[0].split(">")[0].strip()


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans, t0, t1):
    """The gaps of [t0, t1] that no interval of ``spans`` covers."""
    gaps, cur = [], t0
    for a, b in sorted(spans):
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]


@dataclasses.dataclass
class Profile:
    """The profiled stretch: its wall seconds, the device's busy seconds,
    every device operation as (short name, full name, seconds), and the
    idle gaps' seconds by host operation."""

    wall_s: float
    busy_s: float
    device_ops: list
    gaps_by_host_op: dict

    def launches(self) -> int:
        return len(self.device_ops)

    def by_name(self) -> dict:
        out = {}
        for short, _, sec in self.device_ops:
            out[short] = out.get(short, 0.0) + sec
        return out

    def kernel_launches(self, short: str):
        """(element bytes or None, seconds) of each launch of kernel ``short``."""
        return [(ITEMSIZE.get(first_template_arg(full) or ""), sec)
                for s, full, sec in self.device_ops if s == short]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps_by_host_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def reduce_events(events, wall_s: float) -> Profile:
    """A ``Profile`` from the profiler's events (``prof.events()``) of a
    stretch whose host wall was ``wall_s``.  The gaps are taken between
    the first and the last event, host or device; each goes to the
    innermost host operation running at its middle, or to ``host (no
    op)``."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a range the host annotated on the device's timeline (NCCL's
            # "nccl:*") repeats the kernels under it: no operation of its own
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, e.name))
        elif e.device_type == DeviceType.CPU and b > a:
            host.append((a, b, e.name))
    spans = [(a, b) for a, b, _ in dev]
    busy_us = union_seconds(spans)
    host.sort()
    starts = [h[0] for h in host]
    reach, m = [], float("-inf")          # the latest end among host[0..j]
    for h in host:
        m = max(m, h[1])
        reach.append(m)
    gaps = {}
    lo = min([a for a, _ in spans] + starts, default=0.0)
    hi = max([b for _, b in spans] + [h[1] for h in host], default=0.0)
    for a, b in idle_gaps(spans, lo, hi):
        mid = 0.5 * (a + b)
        name = "host (no op)"
        # the latest-starting host operation that still runs at ``mid``
        j = bisect.bisect_right(starts, mid) - 1
        stop = max(j - 2000, -1)
        while j > stop and reach[j] >= mid:
            if host[j][1] >= mid:
                name = host[j][2]
                break
            j -= 1
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    ops = [(short_name(n), n, (b - a) * 1e-6) for a, b, n in dev]
    return Profile(wall_s=wall_s, busy_s=busy_us * 1e-6, device_ops=ops, gaps_by_host_op=gaps)
