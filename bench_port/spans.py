"""The card's idle time put down to the program's layers, from the
``lssp.*`` spans that ``lssp_tpu_torch`` opens (``utils/profile.annotate``)
on the profiler's clock:

    python3 bench_port/spans.py --workload <cell> --seed <n> [--requests <r>]

runs the cell's set-up and warm-up as a run does, then ``--requests``
requests of its window (by default the traffic's ``profile_requests``)
under ``torch.profiler`` (from index 1, as a ``--trace 1`` run profiles
them), and prints one JSON object: the traced stretch's wall, busy and
idle seconds, ``idle_by_layer``, the idle seconds by innermost open span,
``breakdown`` as the result line has it (``trace.reduce_events``), the
traced requests' latencies, the device events the spans left on the
device's timeline, and, with ``--span-cost 1``, what one span costs on
this host with the profiler off and on.  A program without the spans (an
older checkout) puts all its idle time ``outside``.  Single-process cells
only.

``idle_by_layer`` takes the idle gaps as ``trace.reduce_events`` does
(the device's kernels and copies, between the stretch's first and last
event) and splits each gap at the starts and ends of the ``lssp.*``
ranges inside it: each piece goes to ``pc`` if a ``lssp.pc.apply`` is
open over it, else ``krylov`` if a ``lssp.ir.round`` is, else ``facade``
if a request span is, else ``outside`` (the harness between requests).
A gap that starts in one layer's Python and ends in another's is shared
between them by how long each ran.

This runner repeats the traced stretch of ``harness`` beside it, until
``trace.reduce_events`` computes ``idle_by_layer`` itself; then only
``layer_of`` and ``idle_by_layer`` are needed, in ``trace.py``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import trace  # noqa: E402

# the program's request spans: one a public entry point
REQUESTS = frozenset(f"lssp.{e}{m}" for e in ("solve", "solve_ir", "dist_solve", "dist_solve_ir")
                     for m in ("", "_multi"))
LAYERS = ("facade", "krylov", "pc", "outside")


def layer_of(open_names) -> str:
    """The layer of a gap with the ``lssp.*`` ranges ``open_names`` open."""
    if "lssp.pc.apply" in open_names:
        return "pc"
    if "lssp.ir.round" in open_names:
        return "krylov"
    if REQUESTS & set(open_names):
        return "facade"
    return "outside"


def idle_by_layer(events) -> tuple:
    """({layer: idle seconds}, {innermost open span or "(none)": idle
    seconds}) of the stretch that ``events`` (``prof.events()``) cover,
    with the gaps ``trace.reduce_events`` takes, each split where a
    ``lssp.*`` range starts or ends inside it."""
    from torch.autograd import DeviceType
    dev, ranges, lo, hi = [], [], None, None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            dev.append((a, b))
        elif e.device_type == DeviceType.CPU and b > a:
            if e.name.startswith("lssp."):
                ranges.append((a, b, e.name))
        else:
            continue
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
    layers = dict.fromkeys(LAYERS, 0.0)
    by_span = {}
    if lo is None:
        return layers, by_span
    # one sweep over the ranges' and the gaps' ends, in time order (a
    # stable sort keeps a gap's end before the next gap's start)
    marks = [(a, 1, k) for k, (a, _, _) in enumerate(ranges)]
    marks += [(b, -1, k) for k, (_, b, _) in enumerate(ranges)]
    for a, b in trace.idle_gaps(dev, lo, hi):
        marks += [(a, 2, None), (b, -2, None)]
    marks.sort(key=lambda m: m[0])
    open_, in_gap, t0 = {}, False, lo
    for t, kind, k in marks:
        if in_gap and t > t0:
            sec = (t - t0) * 1e-6
            layers[layer_of([n for _, _, n in open_.values()])] += sec
            inner = max(open_.values())[2] if open_ else "(none)"
            by_span[inner] = by_span.get(inner, 0.0) + sec
        t0 = t
        if kind == 1:
            a, b, name = ranges[k]
            open_[k] = (a, -b, name)             # the innermost: latest start, earliest end
        elif kind == -1:
            open_.pop(k, None)
        else:
            in_gap = kind == 2
    return layers, by_span


def span_cost(n: int = 200_000) -> dict:
    """µs a ``with annotate(...)`` costs on this host, with no profiler
    recording and with one recording the host (best of 5 loops of ``n``)."""
    import timeit

    from torch.profiler import ProfilerActivity, profile

    from lssp_tpu_torch.utils.profile import annotate

    def loop():
        for _ in range(n):
            with annotate("lssp.cost"):
                pass

    def best():
        return min(timeit.repeat(loop, number=1, repeat=5)) / n * 1e6

    off = best()
    with profile(activities=[ProfilerActivity.CPU]):
        on = best()
    return {"off_us": off, "on_us": on, "n": n}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=None,
                   help="traced requests (default: the traffic's profile_requests)")
    p.add_argument("--span-cost", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--root", default=ROOT)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    from bench_port import harness
    _, cell, config, traffic = harness.cell_parts(args.workload, args.root)
    if traffic["entry"] == "dist_solve_ir":
        print("spans.py runs single-process cells only", file=sys.stderr)
        return 2
    if args.requests is None:
        args.requests = int(traffic.get("profile_requests", 2))
    session = harness.Session(config, traffic, args.device, harness.Rank())
    device = session.device
    session.system.prepare()
    for j in range(int(traffic.get("warmup_requests", 1))):
        session.request(session.rhs(args.seed, harness.WARMUP, j))
    with harness.profiler(device):                   # the profiler's own start-up
        torch.ones(1, device=device).add_(1)
        harness.sync(device)
    session.request(session.rhs(args.seed, harness.WINDOW, 0))
    latencies, its = [], []
    prof = harness.profiler(device)
    prof.__enter__()
    t0 = time.perf_counter()
    for i in range(1, 1 + args.requests):
        sec, _, nits, _ = session.request(session.rhs(args.seed, harness.WINDOW, i))
        latencies.append(sec)
        its.append(int(nits.max()))
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    events = prof.events()
    p = trace.reduce_events(events, wall)
    layers, by_span = idle_by_layer(events)
    from torch.autograd import DeviceType
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.name.startswith("lssp.")]
    idle = sum(layers.values())
    out = {"cell": args.workload, "seed": args.seed, "requests": args.requests,
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "wall_s": wall, "busy_s": p.busy_s, "idle_s": idle,
           "idle_by_layer": layers,
           "idle_share_by_layer": {k: v / idle for k, v in layers.items()} if idle else {},
           "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
           "per_request_ms": {k: 1e3 * v / args.requests for k, v in layers.items()},
           "per_it_us": {k: 1e6 * v / sum(its) for k, v in layers.items()} if sum(its) else {},
           "its": its, "launches": p.launches(),
           "launches_per_it": p.launches() / sum(its) if sum(its) else None,
           "latencies_s": latencies, "mean_latency_s": sum(latencies) / len(latencies),
           "spans_on_device": len(on_device),
           "spans_on_device_unmarked": sum(not getattr(e, "is_user_annotation", False)
                                           for e in on_device),
           "breakdown": p.breakdown(top=40)}
    if args.span_cost:
        out["span_cost"] = span_cost()
    out["seconds"] = time.perf_counter() - T_START
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
