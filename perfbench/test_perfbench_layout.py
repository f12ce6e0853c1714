"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files: configurations, workloads, traffic drivers and metric
readers; every traffic driver declares what the tools and tests read of
its kind."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_run_of_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e


def test_metrics_and_cells_point_at_each_other():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells.values():
        assert w["chips"] in (1, 4)
        reports = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(reports) >= 2 and any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)


def test_config_files_lie_under_paths_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    found = harness.find_cell(cell, 1, 1.0, False, BENCH)
    assert found.params["config"] == found.entry["config"]
    driver = harness.traffic_driver(found.params["kind"])
    assert callable(driver.run)
    assert {m["name"] for m in found.end_to_end} >= {"setup_s"}
    for m in found.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


@pytest.mark.parametrize("kind", sorted({json.loads(p.read_text())["kind"]
                                          for p in (ROOT / "perfbench" / "workloads").glob("*.json")}))
def test_each_traffic_driver_declares_run_tiny_and_its_control(kind):
    driver = harness.traffic_driver(kind)
    assert callable(driver.run) and callable(driver.tiny)
    control = driver.CONTROL
    assert isinstance(control, harness.Control) and NAME.match(control.check) and control.seconds > 0
    assert isinstance(control.name, str) and control.name


def test_a_missing_name_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no.such_cell", 1, 1.0, False, BENCH)
    with pytest.raises(KeyError):
        harness.metric_reader("no_such_metric")


def test_paths_hold_only_names_the_contract_allows():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
