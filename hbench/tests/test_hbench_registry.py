"""The harness finds every configuration, cell and metric by its name, and
BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from hbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hbench/run.py"]
    assert BENCH["paths"] == ["hbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((run.ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"]
    assert conf["file"] == f"hbench/configs/{conf['name']}.json"
    assert 1 <= len(conf["source"]) <= 200 and conf["source"].startswith("https://")
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    bench, work, conf = run.cell(name)
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and name == f"{entry['config']}.{entry['traffic']}"
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert (run.HERE / "drivers" / f"{work['driver']}.py").is_file()
    assert hasattr(run.load_module(run.HERE / "drivers" / f"{work['driver']}.py",
                                   work["driver"]), "Driver")
    e2e = [m["name"] for m in run.metrics_of(bench, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(bench, name, True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    mod = run.load_module(run.HERE / "metrics" / f"{metric['name']}.py", metric["name"])
    assert callable(mod.read)
    assert NAME.match(metric["name"]) and metric["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
    assert set(metric["workloads"]) <= set(CELLS) if "workloads" in metric else True
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        for cell in metric["workloads"]:
            moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
            assert cell in moved.get("workloads", CELLS)
    if metric["unit"] == "%":
        assert metric["name"].split(".")[0].endswith("_roofline")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
