"""What a run loads: never JAX nor the JAX package (top-level names
compared whole: the port's own name begins with the JAX package's), and
the reference loads nothing of the port.  Without a card a run exits
non-zero and prints no result."""

import subprocess
import sys

from posebench import harness

LOAD_RUN = """
import sys, json
sys.path.insert(0, {root!r})
import torch
from posebench import harness, judge, trace, traffic, work
from posebench.entries import train, infer
from pytorch_pose_estimation_tpu_torch.train import (
    DeviceDataCache, Trainer, load_sbp_predictor)
for m in harness.benchmark()["per_layer"]:
    harness.metric_reader(m["name"])
for c in harness.benchmark()["configs"]:
    harness.network(harness.read_json(harness.ROOT / c["file"]))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
from posebench.reference import augment, model, targets, train
from posebench.networks import darknet19_pose
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_top_level_names():
    modules = {"pytorch_pose_estimation_tpu_torch": None,
               "pytorch_pose_estimation_tpu_torch.train": None,
               "jaxtyping": None, "torch": None}
    assert harness.forbidden_modules(modules) == []
    modules["pytorch_pose_estimation_tpu.models"] = None
    modules["jax._src"] = None
    assert harness.forbidden_modules(modules) == [
        "jax", "pytorch_pose_estimation_tpu"]


def test_a_run_loads_no_jax():
    tops = loaded(LOAD_RUN)
    assert "pytorch_pose_estimation_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded(LOAD_REFERENCE)
    assert not tops & (set(harness.FORBIDDEN)
                       | {"pytorch_pose_estimation_tpu_torch"})


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "posebench/run.py", "--workload", "sbp_train_b256",
         "--seed", "2147483800", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
