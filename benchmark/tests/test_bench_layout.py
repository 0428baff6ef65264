"""Cells, configurations, traffic, limits and metrics are found by name from
files; every cell reports what BENCHMARK.json's format asks of it."""

import json

import pytest

from benchmark import run as bench_run
from benchmark.tests.conftest import ROOT

BENCH = bench_run.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_from_files(cell):
    resolved = bench_run.resolve_cell(BENCH, cell, ROOT)
    assert resolved["cell"]["name"] == cell
    assert (ROOT / "benchmark" / "drivers" / f"{resolved['traffic']['driver']}.py").exists()
    e2e = {m["name"] for m in resolved["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert resolved["per_layer"], "every cell reports a per-layer metric"
    for m in resolved["per_layer"]:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} lacks"
    assert resolved["limits"] and all(v > 0 for v in resolved["limits"].values())


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(bench_run.metric_reader(name))


def test_configs_files_and_widths():
    for c in BENCH["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert (cfg["num_feat"], cfg["num_grow_ch"], cfg["scale"]) == (64, 32, 4)
    blocks = {c["name"]: json.load(open(ROOT / c["file"]))["num_block"] for c in BENCH["configs"]}
    assert blocks == {"realesrgan_x4plus": 23, "realesrgan_x4plus_anime_6b": 6}


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(METRICS)) == len(METRICS) and len(set(CELLS)) == len(CELLS)
