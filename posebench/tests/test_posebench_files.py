"""The benchmark is data: BENCHMARK.json's cells, configurations, traffic
mixes and per-layer metrics are found by name, and a cell, a configuration
and a metric can be added by adding files and entries alone."""

import json
import re
import shutil

import pytest

from posebench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["posebench"]
    assert BENCH["command"] == ["python3", "posebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if metric in BENCH["end_to_end"] else
        {"layer", "moves"})
    assert set(metric) <= allowed
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert (harness.BENCH / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["entry"] in ("train", "infer")
    assert (harness.BENCH / "entries" / f"{c.workload['entry']}.py").exists()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert set(config["reduced"]) == set(data["reduced"])
    for key in config["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size", "channels"))
    used = {w["config"] for w in BENCH["workloads"]}
    assert config["name"] in used


def test_a_cell_config_and_metric_are_added_by_files(tmp_path):
    """A throwaway configuration, traffic mix, cell and metric: new files
    and new BENCHMARK.json entries, no edit of a file that is there."""
    base = tmp_path / "posebench"
    shutil.copytree(harness.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((base / "configs" / "sbp_coco.json").read_text())
    config.update(name="sbp_throwaway", input_size=[384, 288],
                  output_size=[96, 72])
    (base / "configs" / "sbp_throwaway.json").write_text(json.dumps(config))
    (base / "traffic" / "throwaway_pool.json").write_text(json.dumps(
        {"kind": "pool", "pool": 8}))
    (base / "workloads" / "sbp_throwaway_b1.json").write_text(json.dumps(
        {"entry": "infer", "calibration": 4, "warmup_requests": 1,
         "trace_requests": 4, "checked_requests": 4,
         "limits": {"peak_gap": 1.0, "conf_gap": 1.0}}))
    (base / "metrics" / "requests_per_s.infer.py").write_text(
        "def read(m):\n    return m.get('requests_per_s')\n")
    bench["configs"].append({"name": "sbp_throwaway", "source": "x",
                             "file": "posebench/configs/sbp_throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sbp_throwaway_b1",
                               "config": "sbp_throwaway",
                               "traffic": "throwaway_pool", "chips": 1,
                               "why": "a test"})
    for name in ("latency_p50_ms", "latency_p95_ms"):
        bench["end_to_end"].append({"name": name, "unit": "ms",
                                    "better": "lower", "bound": 0.2,
                                    "source": "device_trace",
                                    "workloads": ["sbp_throwaway_b1"]})
    bench["per_layer"].append({"name": "requests_per_s.infer", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "Whole request",
                               "moves": "latency_p50_ms",
                               "workloads": ["sbp_throwaway_b1"]})
    cell = harness.load_cell("sbp_throwaway_b1", bench, base)
    assert cell.config["input_size"] == [384, 288]
    assert cell.traffic["pool"] == 8
    assert [m["name"] for m in cell.per_layer] == ["requests_per_s.infer"]
    read = harness.metric_reader("requests_per_s.infer", base)
    assert read({"requests_per_s": 3.0}) == 3.0
    assert {m["name"] for m in cell.end_to_end} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert harness.entry_module("infer", base).run
