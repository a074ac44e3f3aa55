"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness."""
import glob
import json
import os
import re

import pytest

from bench_port import generators, harness

ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
LAYERS = {"facade", "host input", "Krylov loop", "preconditioner", "ops", "kernels",
          "communicator", "device"}
CELLS = [c["name"] for c in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert MANIFEST["paths"] == ["bench_port"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("name", [e["name"] for k in ("configs", "workloads", "end_to_end",
                                                       "per_layer") for e in MANIFEST[k]]
                         + [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
                         + [r for c in MANIFEST["configs"] for r in c["reduced"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["layer"] in LAYERS and LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(MANIFEST, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        per_layer = harness.metrics_for(MANIFEST, cell, True)
        assert per_layer and all(m["moves"] in e2e for m in per_layer), cell


def test_cells():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)
    for w in MANIFEST["workloads"]:
        assert LINE.match(w["why"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    manifest, c, config, traffic = harness.cell_parts(cell, ROOT)
    assert config["name"] == c["config"]
    assert traffic["entry"] in ("solve_ir", "solve_ir_multi", "dist_solve_ir")
    for m in harness.metrics_for(manifest, cell, False) + harness.metrics_for(manifest, cell,
                                                                               True):
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"] == f"bench_port/configs/{entry['name']}.json"
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert all(r in config for r in entry["reduced"])
    assert "assumed" in config and config["rtol"] > 0
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


CONFIGS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(harness.BENCH,
                                                                          "configs", "*.json")))
TRAFFIC = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(harness.BENCH,
                                                                          "traffic", "*.json")))


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_states_the_matrix_it_builds(name):
    config = harness.load_data("configs", name)
    assert config["name"] == name and NAME.match(name)
    s = generators.structure(generators.build(config))
    assert (s["n"], s["nnz"]) == (config["rows"], config["nnz"])
    assert config["ranks"] >= 1 and config["slots"] >= 1 and config["inner_rtol"] > 0


@pytest.mark.parametrize("name", TRAFFIC)
def test_every_traffic_mix_names_an_entry(name):
    traffic = harness.load_data("traffic", name)
    assert traffic["entry"] in ("solve_ir", "solve_ir_multi", "dist_solve_ir")
    assert traffic["k"] >= 1 and traffic["loop"] == "closed"
    harness.implemented("traffic", traffic, name)
    assert traffic["warmup_requests"] >= 1 and traffic["profile_requests"] >= 1


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(harness.BENCH, "metrics",
                                                               "[a-z]*.py"))),
                         ids=os.path.basename)
def test_every_metric_file_has_a_reader(path):
    assert callable(harness.reader(os.path.basename(path)[:-3]))


def test_bounds_cover_the_run():
    """A full check of 24 cells fits its time: 2 + 14 runs a cell, each
    run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare."""
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200
