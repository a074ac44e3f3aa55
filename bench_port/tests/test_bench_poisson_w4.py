"""The block-Jacobi ILU(0) cell over ranks (``poisson3d_204_ilu0_w4.dist``)
run whole on the CPU at a tiny size: its configuration cut to N = 8 and
its cell to two gloo ranks, in a root of its own.  A sound run is
correct with the ranks agreeing; the control and a run with the halo
exchange left out are not; the program's build counter is read and the
two device-trace readers read nothing without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
CONFIG = "poisson3d_204_ilu0_w4"
CELL = "poisson3d_204_ilu0_w4.dist"
NEW = ("kernel.k4_roofline", "comm.nccl_us_per_it", "setup.dist_build_s")

LEFT_OUT = '''
from lssp_tpu_torch.parallel import dist_ops

def _left_out(to_next, to_prev, mesh):
    return (None if to_next is None else to_next * 0, None if to_prev is None else to_prev * 0)

dist_ops._ring_swap = _left_out
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root with the manifest and the benchmark's data files, the
    configuration at N = 8 (512 rows, 256 a rank) on two ranks."""
    tmp = tmp_path_factory.mktemp("w4")
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), tmp / "bench_port" / kind)
    path = tmp / "bench_port" / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    config.update(N=8, rows=512, nnz=7 * 512 - 6 * 64, ranks=2)
    path.write_text(json.dumps(config))
    manifest = harness.load_manifest()
    for cell in manifest["workloads"]:
        if cell["name"] == CELL:
            cell["chips"] = 2
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(tmp)


def run(root, *extra, env=None, trace=0):
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL, "--seed",
           "2147483659", "--seconds", "0.5", "--trace", str(trace), "--device", "cpu",
           "--root", root, *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.splitlines()[-1])


def test_a_sound_run_is_correct_and_the_ranks_agree(root):
    out = run(root)
    assert out["correct"] is True and out["device"]["count"] == 2
    assert set(out["metrics"]) == {"rhs_per_s", "setup_s"}
    assert out["checks"]["relres_max"]["value"] <= 1e-8
    assert out["checks"]["answers_missing"]["value"] == 0
    assert out["checks"]["ranks_disagree"] == {"value": 0, "limit": 0}


def test_a_traced_run_reads_the_build_and_no_device_metric(root):
    out = run(root, trace=1)
    assert out["correct"] is True
    assert out["metrics"]["setup.dist_build_s"]["value"] > 0
    assert out["metrics"]["setup.dist_build_s"]["unit"] == "s"
    # no card: no K4 launch counted, no device operation traced
    assert "kernel.k4_roofline" not in out["metrics"]
    assert "comm.nccl_us_per_it" not in out["metrics"]
    names = {m["name"] for m in harness.metrics_for(harness.load_manifest(root), CELL, True)}
    assert names == set(NEW)


def test_the_control_is_not_correct(root):
    out = run(root, "--control", "1")
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > 1e-8


def test_without_the_halo_exchange_the_run_is_not_correct(root, tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(LEFT_OUT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), ROOT]))
    assert run(root, env=env)["correct"] is False


def test_the_readers_of_a_program_without_the_counters_read_nothing(monkeypatch):
    """A program that lacks the build and K4 shape counters (one older
    than them) gives the readers nothing to read; they return None and
    raise nothing."""
    from bench_port.record import Run
    from bench_port.trace import Profile
    stub = type(sys)("stub")
    for name in ("lssp_tpu_torch.parallel.dist_solve", "lssp_tpu_torch.ops.dia_spmv_ext"):
        monkeypatch.setitem(sys.modules, name, stub)
    ops = [("dia_spmv_ext_kernel", "void dia_spmv_ext_kernel<float>(float const*)", 1e-4),
           ("ncclDevKernel_SendRecv", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 2e-5)]
    run_ = Run(cell=CELL, config={}, traffic={"k": 1}, latencies=[1.0, 1.0], nits=[[10], [10]],
               window_s=2.0, setup_s=1.0, profiles=[Profile(1.0, 0.5, ops, {})], profiled=[1],
               card="NVIDIA H100 80GB HBM3")
    assert harness.reader("kernel.k4_roofline")(run_) is None
    assert harness.reader("setup.dist_build_s")(run_) is None
    # the trace's NCCL kernels need no counter: 20 µs over 10 iterations
    assert harness.reader("comm.nccl_us_per_it")(run_) == pytest.approx(2.0)


def test_the_k4_roofline_from_the_counted_shapes(monkeypatch):
    """Each traced K4 launch is given the mean least bytes of the counted
    launches of its element size: here one 7-band product and two 3-band
    sweeps of fp32 on one shard of R rows, 1 µs each in the trace."""
    from bench_port import roofline
    from bench_port.record import Run
    from bench_port.trace import Profile
    R, lo = 1000, 100
    by_shape = {(7, lo, lo, R, 1, 4): 1, (3, lo, 0, R, 1, 4): 1, (3, 0, lo, R, 1, 4): 1,
                (7, lo, lo, R, 1, 8): 5}
    fn = type("K4", (), {"by_shape": by_shape})
    stub = type(sys)("stub")
    stub.dia_spmv_ext = fn
    monkeypatch.setitem(sys.modules, "lssp_tpu_torch.ops.dia_spmv_ext", stub)
    ops = [("dia_spmv_ext_kernel", "void dia_spmv_ext_kernel<float>(float const*)", 1e-6)] * 3
    run_ = Run(cell=CELL, config={}, traffic={"k": 1}, latencies=[1.0], nits=[[1]],
               window_s=1.0, setup_s=1.0, profiles=[Profile(1.0, 0.5, ops, {})], profiled=[0],
               card="NVIDIA H100 80GB HBM3")
    least = [(7 * R + R + 2 * lo + R) * 4, (3 * R + R + lo + R) * 4, (3 * R + R + lo + R) * 4]
    want = 100.0 * sum(least) / roofline.PEAK_BYTES_PER_S["NVIDIA H100 80GB HBM3"] / 3e-6
    assert harness.reader("kernel.k4_roofline")(run_) == pytest.approx(want)
