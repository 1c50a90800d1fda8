"""The benchmark is data: BENCHMARK.json's cells, configurations, traffic
mixes, per-layer metrics and networks are found by name, and a cell, a
configuration, a metric and a network can be added by adding files and
entries alone."""

import json
import math
import re
import shutil

import pytest
import torch

from posebench import harness, judge, traffic
from posebench_tiny import flops_counted, tiny

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


# a network file as a later change would add one: a trunk of conv -> BN ->
# ReLU at 1/32 of the input, one x8 bilinear upsample, a 1x1 head
THROWAWAY = '''"""A throwaway network: six conv -> BN -> ReLU layers with a 2x2 max
pool between each two, one x8 bilinear upsample, a 1x1 head.  BN takes
the batch's statistics in train and eval mode alike."""
import math

import torch
import torch.nn.functional as F

port_keys = ()
TRUNK = (16, 32, 32, 64, 64, 128)


def _convs(config):
    """(key, c_in, c_out, kernel, output pixels) of each convolution."""
    size = config["input_size"]
    h, w = (size, size) if isinstance(size, int) else size
    k = int(config["num_keypoints"])
    out, c = [], 3
    for i, c_out in enumerate(TRUNK):
        out.append((f"trunk.{i}", c, c_out, 3, (h >> i) * (w >> i)))
        c = c_out
    head = k if config["kind"] == "sbp" else 1 + 2 * k
    return out + [("head", c, head, 1, (h >> 2) * (w >> 2))]


def weights(config, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    p = {}
    for key, c_in, c_out, k, _ in _convs(config):
        p[key + ".weight"] = torch.randn(
            c_out, c_in, k, k, generator=gen, device=device) / math.sqrt(
                c_in * k * k)
        if key != "head":
            p[key + ".bn.weight"] = torch.ones(c_out, device=device)
            p[key + ".bn.bias"] = torch.ones(c_out, device=device)
    return p


def forward(p, x, config, train, quant=None, stats=None):
    h = x
    for i, (key, *_) in enumerate(_convs(config)[:-1]):
        if i:
            h = F.max_pool2d(h, 2)
        w = p[key + ".weight"]
        if quant is not None:
            h, w = quant.operand(h), quant.operand(w)
        h = F.conv2d(h, w, padding=1)
        if quant is not None:
            h = quant.output(h)
        h = F.relu(F.batch_norm(h, None, None, p[key + ".bn.weight"],
                                p[key + ".bn.bias"], True))
    h = F.interpolate(h, scale_factor=8, mode="bilinear")
    return F.conv2d(h, p["head.weight"])


def groups(config):
    out = {}
    for key, *_ in _convs(config):
        out[key + ".weight"] = "head" if key == "head" else "conv"
        if key != "head":
            out[key + ".bn.weight"] = out[key + ".bn.bias"] = "bn"
    return out


def forward_flops(config):
    return sum(2 * c_in * c_out * k * k * n
               for _, c_in, c_out, k, n in _convs(config))


def train_flops(config):
    _, c_in, c_out, k, n = _convs(config)[0]
    return 3 * forward_flops(config) - 2 * c_in * c_out * k * k * n


def bn_act_elements(config):
    return sum(c_out * n for key, _, c_out, _, n in _convs(config)
               if key != "head")
'''


def test_a_network_is_added_by_files(tmp_path):
    """A throwaway network and a configuration that names it: new files and
    new BENCHMARK.json entries.  The cell finds the network, the train
    entry's reference trains it for two steps under its own groups, and
    its FLOP count is torch's."""
    base = tmp_path / "posebench"
    shutil.copytree(harness.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (base / "networks" / "throwaway.py").write_text(THROWAWAY)
    config = json.loads((base / "configs" / "sbp_coco.json").read_text())
    config.update(name="sbp_throwaway", network="throwaway")
    (base / "configs" / "sbp_throwaway.json").write_text(json.dumps(config))
    (base / "workloads" / "sbp_throwaway_b256.json").write_text(
        (base / "workloads" / "sbp_train_b256.json").read_text())
    bench["configs"].append({"name": "sbp_throwaway", "source": "x",
                             "file": "posebench/configs/sbp_throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sbp_throwaway_b256",
                               "config": "sbp_throwaway",
                               "traffic": "sbp_cache_coco", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).append("sbp_throwaway_b256")

    cell = tiny("sbp_throwaway_b256", bench=bench, base=base)
    net = harness.network(cell.config, base)
    assert cell.net.__file__ == net.__file__ == str(
        base / "networks" / "throwaway.py")
    assert "train_images_per_s" in {m["name"] for m in cell.end_to_end}

    arrays = traffic.cache_arrays(cell.traffic, cell.config, cell.seed)
    entry = harness.entry_module("train", base)
    ref = entry.reference(cell, arrays, torch.device("cpu"), 2)
    groups = net.groups(cell.config)
    assert len(ref["losses"]) == 2
    assert all(math.isfinite(x) for x in ref["losses"])
    assert ref["groups"] == groups and list(ref["grad_norms"]) == list(groups)
    assert set(groups.values()) == {"conv", "head", "bn"}
    assert ref["logits"].shape == (8, 17, 16, 8)
    assert all(v > 0 for v in ref["change_norms"].values())
    assert all(v == 0 for v in judge.train_numbers(ref, ref).values())

    assert flops_counted(net, cell.config) == (
        net.forward_flops(cell.config), net.train_flops(cell.config))
