"""Every cell of BENCHMARK.json loads by name from its files, and the file
keeps to the benchmark's contract."""

import json
import math
import re

import pytest

from benchmark import cells, harness
from benchmark.cells import HERE, ROOT
from benchmark.reference import judge

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_budget_fits_with_the_full_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = cells.load(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert name == f"{w['config']}.{w['traffic']}"
    assert cell.chips == 1 and len(w["why"]) <= 200
    assert cell.config["name"] == w["config"]
    assert cell.points["count"] >= 2
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_configuration(entry):
    assert entry["file"].startswith("benchmark/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert config["precision"] in ("z", "c")
    assert set(config["limits"]) >= set(judge.NUMBERS)
    assert all(math.isfinite(v) and v >= 0 for v in config["limits"].values())
    assert len(entry["source"]) <= 200 and entry["source"].startswith("http")


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")
