"""``spans.py``: the idle gaps shared out to the program's layers by the
``lssp.*`` ranges open over each piece of them, on made-up events; the existing
reduction and every reader unchanged by those ranges; and a CPU run of
the tool on a tiny cell."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench_port import harness, spans, trace
from bench_port.record import Run
from bench_port.tests.test_bench_runs import tiny  # noqa: F401  (the fixture)
from bench_port.tests.test_bench_yardstick import fake_event

K1 = "void (anonymous namespace)::dia_spmv_kernel<float>(float const*)"
K2 = "void (anonymous namespace)::neumann_wavefront_kernel<float, 8>(Apply<float>)"


def events(with_spans=True):
    """Two requests' worth of made-up events, in µs: the device busy at
    10-20, 40-45, 60-70, 90-95 and 130-140; gaps 0-10 (the harness, then
    the request), 20-40 (the fingerprint: facade), 45-60 (a round: krylov),
    70-90 (the round, then a PC apply), 95-130 (AMG levels inside the
    apply: pc), 140-150 (the round's end, the request's, the harness)."""
    ev = [fake_event("aten::empty", 0, 1, False),
          fake_event(K1, 10, 20, True),
          fake_event("aten::item", 42, 50, False),
          fake_event(K2, 40, 45, True),
          fake_event(K1, 60, 70, True),
          fake_event("cudaLaunchKernel", 85, 92, False),
          fake_event(K2, 90, 95, True),
          fake_event(K1, 130, 140, True),
          fake_event("aten::add", 149, 150, False)]
    if with_spans:
        ev += [fake_event("lssp.solve_ir", 6, 144, False),
               fake_event("lssp.memo.fingerprint", 21, 39, False),
               fake_event("lssp.ir.round", 41, 142, False),
               fake_event("lssp.krylov.inner", 44, 141, False),
               fake_event("lssp.pc.apply", 71, 140, False),
               fake_event("lssp.amg.level.0", 72, 139, False),
               fake_event("lssp.amg.level.1", 96, 128, False),
               # the profiler's mirror of a range on the device's timeline
               fake_event("lssp.pc.apply", 71, 140, True, annotation=True)]
    return ev


def test_gaps_are_shared_by_the_layers_open_over_them():
    layers, by_span = spans.idle_by_layer(events())
    assert layers == pytest.approx({"facade": 26e-6, "krylov": 18e-6, "pc": 54e-6,
                                    "outside": 12e-6})
    assert by_span == pytest.approx({"(none)": 12e-6, "lssp.solve_ir": 8e-6,
                                     "lssp.memo.fingerprint": 18e-6,
                                     "lssp.krylov.inner": 17e-6, "lssp.ir.round": 1e-6,
                                     "lssp.pc.apply": 1e-6, "lssp.amg.level.0": 21e-6,
                                     "lssp.amg.level.1": 32e-6})
    # the layers share out exactly the idle that the reduction sees
    p = trace.reduce_events(events(), wall_s=150e-6)
    assert sum(layers.values()) == pytest.approx(sum(p.gaps_by_host_op.values()))
    assert sum(layers.values()) == pytest.approx(150e-6 - p.busy_s)
    assert sum(by_span.values()) == pytest.approx(sum(layers.values()))


@pytest.mark.parametrize("apply_at,krylov,pc", [(25, 15e-6, 5e-6), (15, 5e-6, 15e-6),
                                                (11, 1e-6, 19e-6)])
def test_a_gap_across_a_round_and_an_apply_is_split_where_the_apply_opens(apply_at, krylov,
                                                                          pc):
    """The card drains at 10 (the round's ``.item()``); the round's Python
    runs until the PC apply opens at ``apply_at`` and launches at 30.
    Wherever the gap's middle falls, each layer gets the time its own
    Python ran."""
    ev = [fake_event(K1, 0, 10, True), fake_event(K2, 30, 40, True),
          fake_event("lssp.solve_ir", 0, 40, False), fake_event("lssp.ir.round", 1, 40, False),
          fake_event("lssp.krylov.inner", 2, 40, False),
          fake_event("lssp.pc.apply", apply_at, 40, False)]
    layers, by_span = spans.idle_by_layer(ev)
    assert layers == pytest.approx({"facade": 0.0, "krylov": krylov, "pc": pc,
                                    "outside": 0.0})
    assert by_span == pytest.approx({"lssp.krylov.inner": krylov, "lssp.pc.apply": pc})


def test_without_spans_everything_is_outside():
    layers, by_span = spans.idle_by_layer(events(with_spans=False))
    assert layers == pytest.approx({"facade": 0.0, "krylov": 0.0, "pc": 0.0,
                                    "outside": 110e-6})
    assert list(by_span) == ["(none)"]
    assert spans.idle_by_layer([]) == (dict.fromkeys(spans.LAYERS, 0.0), {})


@pytest.mark.parametrize("names,layer", [
    (["lssp.solve_ir", "lssp.ir.round", "lssp.krylov.inner", "lssp.pc.apply"], "pc"),
    (["lssp.dist_solve_ir_multi", "lssp.ir.round", "lssp.comm.all_gather"], "krylov"),
    (["lssp.solve_multi", "lssp.pc.apply"], "pc"),
    (["lssp.solve", "lssp.reorder_convert"], "facade"),
    (["lssp.pc_build"], "outside"),
    ([], "outside")])
def test_layer_of(names, layer):
    assert spans.layer_of(names) == layer


def run_of(profile):
    return Run(cell="c", config={}, traffic={"k": 1}, latencies=[0.1, 0.1, 0.1],
               nits=[np.array([3]), np.array([4]), np.array([5])], window_s=0.3,
               setup_s=1.0, phases_setup={"reorder_convert": 1.0, "upload": 0.5,
                                          "pc_build": 2.0},
               phases_window={"reorder_convert": 0.06}, profiles=[profile], profiled=[1, 2],
               matrix={"n": 1000, "nd": 7, "nd_lower": 3, "nd_upper": 3},
               card="NVIDIA H100 80GB HBM3")


def test_the_spans_change_no_reader():
    with_spans = trace.reduce_events(events(), wall_s=150e-6)
    without = trace.reduce_events(events(with_spans=False), wall_s=150e-6)
    assert with_spans.busy_s == without.busy_s and with_spans.launches() == without.launches()
    assert with_spans.device_ops == without.device_ops
    assert sum(with_spans.gaps_by_host_op.values()) == pytest.approx(
        sum(without.gaps_by_host_op.values()))
    # only the names of the gaps that no host operation covered change
    assert "host (no op)" in without.gaps_by_host_op
    assert "host (no op)" in with_spans.gaps_by_host_op           # 0-10 and 140-150
    assert with_spans.gaps_by_host_op["host (no op)"] < without.gaps_by_host_op["host (no op)"]
    files = sorted(glob.glob(os.path.join(harness.BENCH, "metrics", "*.py")))
    names = [os.path.basename(f)[:-3] for f in files if not f.endswith("__init__.py")]
    assert len(names) >= 14
    for name in names:
        read = harness.reader(name)
        assert read(run_of(with_spans)) == read(run_of(without)), name


def test_the_tool_on_a_tiny_cell(tiny):  # noqa: F811
    cmd = [sys.executable, os.path.join(harness.BENCH, "spans.py"), "--workload",
           "poisson3d_128_ilu0.single", "--seed", "2147483659",
           "--device", "cpu", "--root", tiny]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["idle_by_layer"]) == set(spans.LAYERS)
    assert sum(out["idle_by_layer"].values()) == pytest.approx(out["idle_s"])
    # the traffic's profile_requests (3 for ``single``) unless --requests says
    assert out["requests"] == 3
    assert len(out["latencies_s"]) == 3 and all(i > 0 for i in out["its"])
    assert out["spans_on_device"] == 0 and out["card"] == "cpu"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    amg = [sys.executable, os.path.join(harness.BENCH, "spans.py"), "--workload",
            "aniso2d_1024_saamg.single", "--seed", "1", "--requests", "1", "--device", "cpu",
            "--root", tiny, "--span-cost", "1"]
    p = subprocess.run(amg, capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    cost = json.loads(p.stdout.strip().splitlines()[-1])["span_cost"]
    assert 0 < cost["off_us"] < cost["on_us"]
