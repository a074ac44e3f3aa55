"""Whole runs of the harness on the CPU at tiny sizes: the result line,
the control and each fault a cell can have coming out not correct, a
cell, a traffic mix and a metric added by adding files alone, and no
module of JAX or the JAX package loaded.  ``--device cpu`` skips the
look for a card; everything else is a run as on the chip."""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_port import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
DIST = "aniso2d_2048_saamg_w4.dist"
TINY = {"poisson3d_128_ilu0": {"N": 8}, "aniso2d_1024_saamg": {"N": 24, "maxit": 200},
        "aniso2d_2048_saamg_w4": {"N": 24, "ranks": 2, "maxit": 200}}


@pytest.fixture
def tiny(tmp_path):
    """A root holding the manifest and the benchmark's data files, each
    configuration cut to a few hundred rows, the distributed cell on two
    ranks, and the AMG configurations' iteration cap to 200, so that the
    control, whose fp32 GMRES stalls, ends soon."""
    shutil.copytree(os.path.join(BENCH, "configs"), tmp_path / "bench_port" / "configs")
    shutil.copytree(os.path.join(BENCH, "traffic"), tmp_path / "bench_port" / "traffic")
    shutil.copytree(os.path.join(BENCH, "metrics"), tmp_path / "bench_port" / "metrics")
    for name, change in TINY.items():
        path = tmp_path / "bench_port" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(change)
        path.write_text(json.dumps(config))
    manifest = harness.load_manifest()
    # the distributed cell (left out of the manifest until its spread fits a
    # bound, PERF.md) on two ranks
    manifest["workloads"].append({"name": DIST, "config": "aniso2d_2048_saamg_w4",
                                  "traffic": "dist", "chips": 2, "why": "w"})
    manifest["per_layer"].append({"name": "comm.collectives_per_it", "unit": "collectives/it",
                                  "better": "lower", "source": "program_counter",
                                  "layer": "communicator", "moves": "rhs_per_s",
                                  "workloads": [DIST]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(tmp_path)


def run(cell, root, seed=3_000_000_019, seconds=0.3, trace=False, control=False):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                            root=root, control=control)


def run_script(root, cell, *extra, env=None, seconds=0.3, seed=2_147_483_659):
    """run.py in a process of its own: (return code, stdout, stderr)."""
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", "0", "--device", "cpu", "--root",
           root, *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.parametrize("cell", ["poisson3d_128_ilu0.single", "aniso2d_1024_saamg.single",
                                  "poisson3d_128_ilu0.block8"])
def test_a_sound_run(cell, tiny):
    out = run(cell, tiny)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in harness.metrics_for(harness.load_manifest(tiny), cell, False)}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert out["checks"]["relres_max"]["value"] <= 1e-8


def test_a_traced_run(tiny):
    out = run("poisson3d_128_ilu0.single", tiny, seconds=1.0, trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: the device readings are left out, the program's own are there
    for name in ("krylov.inner_its", "facade.prepare_ms", "setup.convert_s",
                 "setup.pc_build_s"):
        assert out["metrics"][name]["value"] > 0
    for name in ("kernel.k1_roofline", "kernel.k2_roofline", "device.idle"):
        assert name not in out["metrics"]
    assert list(out)[-1] == "checks"


def test_the_answers_are_kept_apart_from_the_program():
    like = torch.zeros(6, 2, dtype=torch.float64)
    answers = harness.Answers(like, slots=2)
    xs = [torch.full((6, 2), float(j), dtype=torch.float64) for j in range(4)]
    answers.keep(xs[0], traced=False)
    answers.keep(xs[1], traced=True)
    answers.keep(None, traced=True)
    answers.keep(xs[2][:, :1], traced=True)      # another shape: straight to the host
    answers.keep(xs[3], traced=True)
    assert answers.held == [1, 4] and answers.slots == []
    for x in xs:
        x.add_(100)                               # the program reuses its buffers
    answers.release()
    assert answers.held == [] and answers[2] is None
    assert [float(a.max()) for a in answers if a is not None] == [0.0, 1.0, 2.0, 3.0]
    assert all(a.device.type == "cpu" for a in answers if a is not None)


def test_the_same_seed_gives_the_same_rhs():
    a = harness.make_rhs(2 ** 31 + 11, 0, 5, 64, 1, "cpu")
    assert torch.equal(a, harness.make_rhs(2 ** 31 + 11, 0, 5, 64, 1, "cpu"))
    assert not torch.equal(a, harness.make_rhs(2 ** 31 + 11, 0, 6, 64, 1, "cpu"))
    assert not torch.equal(a, harness.make_rhs(2 ** 31 + 11, 1, 5, 64, 1, "cpu"))
    assert harness.make_rhs(-3, 0, 0, 8, 4, "cpu").shape == (8, 4)


@pytest.mark.parametrize("cell", ["poisson3d_128_ilu0.single", "aniso2d_1024_saamg.single",
                                  "poisson3d_128_ilu0.block8"])
def test_the_control_is_not_correct(cell, tiny):
    out = run(cell, tiny, control=True)
    assert out["correct"] is False
    assert out["checks"]["relres_max"]["value"] > 1e-8


def unchanged(x):
    return torch.zeros_like(x)


def altered(x):
    x = x.clone()
    x[x.shape[0] // 2] += 1e-4 * float(x.abs().max())
    return x


def half_left_out(x):
    x = x.clone()
    x[:, x.shape[1] // 2:] = 0
    return x


@pytest.mark.parametrize("cell,entry,fault", [
    ("poisson3d_128_ilu0.single", "solve_ir", unchanged),
    ("poisson3d_128_ilu0.single", "solve_ir", altered),
    ("aniso2d_1024_saamg.single", "solve_ir", unchanged),
    ("aniso2d_1024_saamg.single", "solve_ir", altered),
    ("poisson3d_128_ilu0.block8", "solve_ir_multi", unchanged),
    ("poisson3d_128_ilu0.block8", "solve_ir_multi", altered),
    ("poisson3d_128_ilu0.block8", "solve_ir_multi", half_left_out),
])
def test_a_fault_is_not_correct(cell, entry, fault, tiny, monkeypatch):
    import lssp_tpu_torch as lt
    sound = getattr(lt, entry)

    def broken(*args, **kw):
        x, info = sound(*args, **kw)
        return fault(x), info

    monkeypatch.setattr(lt, entry, broken)
    out = run(cell, tiny)
    assert out["correct"] is False, fault.__name__


SITE = '''
from lssp_tpu_torch.parallel import dist_ops

def _left_out(to_next, to_prev, mesh):
    return (None if to_next is None else to_next * 0, None if to_prev is None else to_prev * 0)

dist_ops._ring_swap = _left_out
'''


def test_the_distributed_cell(tiny, tmp_path):
    """Two gloo ranks: a sound run is correct and the ranks agree; with the
    halo exchange left out on every rank it is not."""
    rc, stdout, stderr = run_script(tiny, DIST)
    assert rc == 0, stderr[-2000:]
    out = json.loads(stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["count"] == 2
    assert out["metrics"]["rhs_per_s"]["value"] > 0
    assert out["checks"]["ranks_disagree"] == {"value": 0, "limit": 0}
    assert stderr.rstrip().splitlines()[-1].startswith("check ranks_disagree 0 limit 0")
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), ROOT]))
    rc, stdout, stderr = run_script(tiny, DIST, env=env)
    assert rc == 0, stderr[-2000:]
    assert json.loads(stdout.splitlines()[-1])["correct"] is False


def test_the_distributed_control(tiny):
    rc, stdout, stderr = run_script(tiny, DIST, "--control", "1")
    assert rc == 0, stderr[-2000:]
    assert json.loads(stdout.splitlines()[-1])["correct"] is False


def test_a_cell_a_mix_and_a_metric_added_by_files_alone(tiny):
    base = os.path.join(tiny, "bench_port")
    config = json.load(open(os.path.join(base, "configs", "poisson3d_128_ilu0.json")))
    config.update(name="poisson3d_6_ilu0", N=6, reduced=["N"])
    json.dump(config, open(os.path.join(base, "configs", "poisson3d_6_ilu0.json"), "w"))
    mix = json.load(open(os.path.join(base, "traffic", "block8.json")))
    mix.update(k=3)
    json.dump(mix, open(os.path.join(base, "traffic", "block3.json"), "w"))
    with open(os.path.join(base, "metrics", "krylov_max_its.py"), "w") as f:
        f.write("def read(run):\n    return float(max(int(v.max()) for v in run.nits))\n")
    manifest = harness.load_manifest(tiny)
    manifest["configs"].append({"name": "poisson3d_6_ilu0", "source": "s",
                                "file": "bench_port/configs/poisson3d_6_ilu0.json",
                                "reduced": ["N"], "why": "w"})
    manifest["workloads"].append({"name": "poisson3d_6_ilu0.block3",
                                  "config": "poisson3d_6_ilu0", "traffic": "block3",
                                  "chips": 1, "why": "w"})
    manifest["per_layer"].append({"name": "krylov.max_its", "unit": "its", "better": "lower",
                                  "source": "program_counter", "layer": "Krylov loop",
                                  "moves": "rhs_per_s",
                                  "workloads": ["poisson3d_6_ilu0.block3"]})
    json.dump(manifest, open(os.path.join(tiny, "BENCHMARK.json"), "w"))
    out = run("poisson3d_6_ilu0.block3", tiny, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["krylov.max_its"]["value"] >= 1


def test_without_a_card_there_is_no_result(tiny):
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
           "poisson3d_128_ilu0.single", "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    program to measure, so no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "bench_port/run.py", "--workload", "poisson3d_128_ilu0.single",
           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


SOURCES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    assert not tops & {"chip_smoke", "bench", "benchmarks"}


@pytest.mark.parametrize("name", ["reference.py", "generators.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in imports(os.path.join(BENCH, name))}
    assert tops <= {"__future__", "numpy", "scipy"}


def test_no_forbidden_module_after_a_run(tiny):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from bench_port import harness\n"
            "harness.run_cell('poisson3d_128_ilu0.single', 5, 0.2, True, time.perf_counter(),"
            " device='cpu', root=%r)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % (ROOT, tiny))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.splitlines()[-1].replace("'", '"')))
    assert "lssp_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
    assert harness.forbidden_modules() == [] or "lssp_tpu" in sys.modules


def test_a_forbidden_module_refuses_the_run(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert run("poisson3d_128_ilu0.single", tiny) is None
    np.testing.assert_equal(harness.forbidden_modules(), ["jax"])


def test_a_reader_that_loads_jax_refuses_the_run(tiny, tmp_path, monkeypatch):
    """A metric's reader that imports (a stub of) ``jax`` after the window
    has closed: the run gives no result."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    with open(os.path.join(tiny, "bench_port", "metrics", "krylov_via_jax.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    manifest = harness.load_manifest(tiny)
    manifest["per_layer"].append({"name": "krylov.via_jax", "unit": "its", "better": "lower",
                                  "source": "program_counter", "layer": "Krylov loop",
                                  "moves": "rhs_per_s",
                                  "workloads": ["poisson3d_128_ilu0.single"]})
    json.dump(manifest, open(os.path.join(tiny, "BENCHMARK.json"), "w"))
    try:
        assert run("poisson3d_128_ilu0.single", tiny, trace=True) is None
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)


@pytest.mark.parametrize("kind,name,key,value", [
    ("traffic", "single", "clients", 4),
    ("traffic", "single", "loop", "open"),
    ("traffic", "block8", "rhs", "uniform"),
    ("configs", "poisson3d_128_ilu0", "outer_dtype", "float32"),
])
def test_a_setting_the_harness_does_not_run_is_refused(tiny, kind, name, key, value):
    path = os.path.join(tiny, "bench_port", kind, f"{name}.json")
    data = json.load(open(path))
    data[key] = value
    json.dump(data, open(path, "w"))
    cell = "poisson3d_128_ilu0." + ("block8" if name == "block8" else "single")
    with pytest.raises(ValueError, match=f"{key} .* is not implemented"):
        run(cell, tiny)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["poisson3d_128_ilu0.single", "aniso2d_1024_saamg.single",
                                  "poisson3d_128_ilu0.block8"])
def test_a_short_run_on_the_card(cell, card):
    """The cell at its own size for a few seconds: correct, on the card."""
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell, "--seed",
           "2147483701", "--seconds", "3", "--trace", "0"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_the_readings_separate_the_program_from_the_control(tiny):
    cmd = [sys.executable, os.path.join(BENCH, "readings.py"), "--workload",
           "poisson3d_128_ilu0.single", "--seeds", "11,12", "--requests", "2",
           "--control-seeds", "13", "--device", "cpu", "--root", tiny]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert set(out["program"]) == {"11", "12"} and set(out["control"]) == {"13"}
    assert out["lower"] < out["limit"] < out["upper"]
