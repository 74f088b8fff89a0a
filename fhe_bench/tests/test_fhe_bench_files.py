"""Every file that BENCHMARK.json names loads by its name, and the file
keeps to the benchmark's contract."""

import hashlib
import json
import re

import pytest

from fhe_bench import run as bench_run
from fhe_bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fhe_bench/run.py"]
    assert BENCH["paths"] == ["fhe_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads_and_matches_its_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"fhe_bench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert set(data["params"]) <= set(data["assumed"]), "every size not checked against the source is assumed"
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    _, cfg, traffic = bench_run.load_cell(cell["name"])
    assert cfg["name"] == cell["config"] and traffic["warmup"] == {"evaluations": 1}
    path = ROOT / traffic["circuit"]
    assert hashlib.sha256(path.read_bytes()).hexdigest() == traffic["sha256"]
    e2e = bench_run.cell_metrics(BENCH, cell["name"], False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert bench_run.cell_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(bench_run.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_file_is_used():
    """A configuration, traffic mix or metric reader that no entry names
    waits for the change that adds its cell."""
    here = ROOT / "fhe_bench"
    assert {p.stem for p in (here / "configs").glob("*.json")} == {c["name"] for c in BENCH["configs"]}
    assert {p.stem for p in (here / "traffic").glob("*.json")} == {w["traffic"] for w in BENCH["workloads"]}
    names = {m["name"] for m in METRICS}
    readers = {p.stem for p in (here / "metrics").glob("*.py")}
    assert readers == {n if n in readers else n.rsplit(".", 1)[0] for n in names}
