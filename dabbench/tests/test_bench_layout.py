"""Everything the harness runs is found by name: BENCHMARK.json's
configurations, cells and metrics, the workload files, drivers and
per-layer readers."""

import importlib
import json

import pytest

from dabbench import run
from dabbench.gen.loop import load_config
from dabbench.tests.conftest import ROOT, bench_with_left_out

BENCH = bench_with_left_out()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_what_the_harness_finds(cell):
    wl = run.load_workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == wl["config"] and entry["chips"] == wl["chips"]
    assert cell == f"{wl['config']}.{entry['traffic']}"
    if "why" in entry:
        assert entry["why"] == wl["why"]
    load_config(wl["config"])
    drv = importlib.import_module(f"dabbench.drivers.{wl['driver']}")
    assert hasattr(drv, "Driver")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert "setup_s" in wl["end_to_end"] and len(wl["end_to_end"]) >= 2
    for name in wl["end_to_end"]:
        assert cell in e2e[name].get("workloads", [cell])
    assert wl["per_layer"]
    for name in wl["per_layer"]:
        mod = run.read_layer_metric(name)
        assert mod.UNIT == layer[name]["unit"]
        assert cell in layer[name]["workloads"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        wl = run.load_workload(cell)
        assert metric in run.cell_metrics(BENCH["per_layer"], wl,
                                          "per_layer")
        assert m["moves"] in run.cell_metrics(BENCH["end_to_end"], wl,
                                              "end_to_end")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_metric_is_reported_where_listed(metric):
    m = next(x for x in BENCH["end_to_end"] if x["name"] == metric)
    for cell in m.get("workloads", CELLS):
        wl = run.load_workload(cell)
        assert metric in run.cell_metrics(BENCH["end_to_end"], wl,
                                          "end_to_end")


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_config_as_run(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == cfg and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    cus = [0] * 864
    for s in data["services"]:
        from dabbench.reference.receiver import Reference
        for cu in range(s["start_cu"], s["start_cu"] + Reference._cus(s)):
            cus[cu] += 1
    assert max(cus) == 1


def test_every_file_of_the_harness_is_named_from_a_name():
    import re
    for path in (ROOT / "dabbench").rglob("*"):
        if path.is_file() and ".cache" not in path.parts \
                and "__pycache__" not in path.parts:
            rel = str(path.relative_to(ROOT))
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["dabbench"]
    cells = {w["name"] for w in bench["workloads"]}
    assert all((ROOT / "dabbench" / "workloads" / f"{c}.json").exists()
               for c in cells)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert set(m["workloads"]) <= cells
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
