"""What every cell shares: its files, the checks around a run, the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
that belongs to it is found by name: ``workloads/<cell>.json`` (the entry
kind and the limits of the comparison), ``configs/<config>.json`` (the
model's sizes), ``traffic/<traffic>.json`` (what the generator makes),
``metrics/<metric>.py`` (one reader per per-layer metric),
``entries/<entry>.py`` (the driver of one kind of run) and
``networks/<network>.py`` (the network that the configuration names).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_pose_estimation_tpu")
# the network of a configuration without a ``network`` key
DEFAULT_NETWORK = "darknet19_pose"
# build and kernel caches of the program and of torch, inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One cell as a run sees it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    base: Path = BENCH

    @property
    def net(self):
        """The module of the configuration's network (``network``)."""
        return network(self.config, self.base)


def load_cell(name: str, bench: Optional[dict] = None,
              base: Path = BENCH) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``) with its files
    under ``base``, and the metrics it reports."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    config = read_json(base / "configs" / f"{entry['config']}.json")
    traffic = read_json(base / "traffic" / f"{entry['traffic']}.json")
    workload = read_json(base / "workloads" / f"{name}.json")

    def reported(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, int(entry["chips"]), config, traffic, workload, e2e,
                per_layer, base=base)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, base: Path = BENCH) -> Callable:
    """``read(measured) -> value or None`` of the per-layer metric
    ``name``, from ``metrics/<name>.py``."""
    module = load_module(base / "metrics" / f"{name}.py",
                         "posebench_metric_" + name.replace(".", "_"))
    return module.read


def network(config: dict, base: Path = BENCH):
    """``networks/<name>.py`` of the network that ``config`` names under
    ``network`` (``DEFAULT_NETWORK`` where it names none): its seeded
    weights, fp32 forward, parameter groups and work an image."""
    name = config.get("network", DEFAULT_NETWORK)
    if base == BENCH:
        return importlib.import_module(f"posebench.networks.{name}")
    return load_module(base / "networks" / f"{name}.py",
                       f"posebench_network_{name}")


def cell_weights(cell: Cell, device) -> Dict[str, object]:
    """The cell's seeded fp32 weights, its network's, drawn from the run's
    seed."""
    return cell.net.weights(cell.config, torch_seed(cell.seed, 3), device)


def entry_module(kind: str, base: Path = BENCH):
    """``entries/<kind>.py``, imported by its package name where it is
    this benchmark's (a rank started by spawn imports its functions so)."""
    if base == BENCH:
        return importlib.import_module(f"posebench.entries.{kind}")
    return load_module(base / "entries" / f"{kind}.py",
                       f"posebench_entry_{kind}")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


def use_checkout_caches(root: Path = ROOT) -> None:
    """Point torch's and Triton's caches at fixed directories inside the
    checkout (the port builds its own kernels under ``build/kernels``)."""
    for var, sub in CACHE_DIRS.items():
        path = root / "build" / "posebench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def torch_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit seed for torch and numpy generators from any whole
    ``seed``, one per ``stream``."""
    return (int(seed) * 1000003 + 7919 * int(stream)) % (2 ** 63)


def card_info() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": "unavailable"}
    return {"nvidia_smi": out}


class Stopwatch:
    """Seconds of the parts of a run, reported on standard error."""

    def __init__(self):
        import time
        self._now = time.perf_counter
        self._last = self._now()
        self.parts: Dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = self._now()
        self.parts[name] = now - self._last
        self._last = now

    def report(self, what: str) -> None:
        print(f"posebench: {what}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in self.parts.items()),
            file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What an entry hands back: end-to-end metrics (trace 0) or the
    measurements the per-layer readers read (trace 1), the device's
    numbers, and the comparison."""
    attempted: int
    failed: int
    e2e: Dict[str, float] = field(default_factory=dict)
    measured: Dict[str, object] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number is finite and within its limit."""
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def result_line(cell: Cell, out: Outcome, device_kind: str,
                card: Optional[dict] = None) -> dict:
    """The run's result object; the comparison's key comes last."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.measured)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cell.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": passes(out.checks) and out.failed == 0,
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if cell.trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    if card:
        line["card"] = card
    line["checks"] = out.checks
    return line


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
