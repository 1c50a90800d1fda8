"""The port's spans and counters (``tracing``): off they record nothing and
open no profiler range; on they nest, count and show in a profiler trace;
the train steps, the device cache and the Trainer's set-up carry them, and
the steps' ``marker`` hook is called as before, each call where its span
ends.  Tiny stand-in models on the CPU, so that each test takes well under
a second."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_pose_estimation_tpu_torch import optim, tracing
from pytorch_pose_estimation_tpu_torch.parallel import mesh
from pytorch_pose_estimation_tpu_torch.profile_train_step import busy_us
from pytorch_pose_estimation_tpu_torch.train import (
    DeviceDataCache, Trainer, make_sbp_steps, make_spm_steps)
from pytorch_pose_estimation_tpu_torch.train import trainer as trainer_mod
from pytorch_pose_estimation_tpu_torch.train_classifier import \
    make_classifier_steps

K, HW, OUT, B = 17, (64, 48), (16, 12), 2
STEP_PARTS = ["train.draw", "train.augment", "train.targets",
              "train.forward", "train.backward", "train.optimizer"]
# the marker names of a step and the span each follows
MARKS = {"augment": "train.augment", "targets": "train.targets",
         "forward_backward": "train.backward",
         "all_reduce": "train.all_reduce", "optimizer": "train.optimizer"}


class TinyPose(nn.Module):
    """A 3x3 conv to ``maps`` channels at a quarter of the input size."""
    dtype = torch.float32

    def __init__(self, maps: int):
        super().__init__()
        self.conv = nn.Conv2d(3, maps, 3, padding=1)

    def forward(self, x):
        return F.avg_pool2d(self.conv(x), 4)


class TinyClassifier(nn.Module):
    def __init__(self, classes: int):
        super().__init__()
        self.fc = nn.Linear(3, classes)

    def forward(self, x, mask):
        return self.fc(x.mean((2, 3)))


def _sgd(model):
    return optim.get_optimizer("sgd", list(model.parameters()), lr=1e-3,
                               momentum=0.9, weight_decay=5e-3,
                               nesterov=True)


def _sbp():
    rng = np.random.RandomState(0)
    model = TinyPose(K)
    step, _ = make_sbp_steps(model, _sgd(model), list(HW), OUT, K, 2.0,
                             0.25, augment={"clahe_prob": 0.5})
    batch = {"image": torch.from_numpy(
        rng.randint(0, 256, (B, *HW, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(np.stack(
            [rng.uniform(0, HW[1], (B, K)), rng.uniform(0, HW[0], (B, K))],
            -1).astype(np.float32)),
        "joints_vis": torch.ones(B, K)}
    return step, batch


def _spm():
    rng = np.random.RandomState(0)
    model = TinyPose(1 + 2 * K)
    step, _ = make_spm_steps(model, _sgd(model), 64, 16, K, 1.0, 0.5,
                             augment={"clahe_prob": 0.5})
    joints = np.zeros((B, 3, K, 2), np.float32)
    joints[:, 0] = rng.uniform(1, 63, (B, K, 2))
    centers = np.zeros((B, 3, 1, 2), np.float32)
    centers[:, 0, 0] = 32.0
    batch = {"image": torch.from_numpy(
        rng.randint(0, 256, (B, 64, 64, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(joints),
        "centers": torch.from_numpy(centers)}
    return step, batch


def _run(make, marker=None):
    step, batch = make()
    gen, host_gen = torch.Generator().manual_seed(1), \
        torch.Generator().manual_seed(1)
    return step(batch, gen, host_gen, marker=marker)


def _last_ended(rec):
    ended = [s for s in rec.spans if s.end_ns is not None]
    return max(ended, key=lambda s: s.end_ns).name


def test_off_opens_no_range_and_records_nothing(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: calls.append(a) or real(*a))
    assert tracing._open is None
    assert tracing.span("train.step") is tracing.span("x", sync=True)
    tracing.count("setup.cache.bytes", 5)
    loss = _run(_sbp)
    assert torch.isfinite(loss) and calls == []
    with tracing.recording("cpu") as rec:
        with tracing.span("a"):
            pass
    assert [c[0] for c in calls] == ["pose.a"]
    assert rec.counters == {} and tracing._open is None


def test_nested_spans_counters_and_summary():
    with tracing.recording("cpu") as rec:
        assert tracing._open is rec
        with tracing.span("outer") as outer:
            with tracing.span("inner") as inner:
                tracing.count("n")
            with tracing.span("inner"):
                tracing.count("n", 4)
        with tracing.recording("cpu") as nested:
            with tracing.span("elsewhere"):
                tracing.count("n", 100)
        assert tracing._open is rec
        with tracing.span("after"):
            pass
    assert tracing._open is None
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("outer", None), ("inner", outer.id), ("inner", outer.id),
        ("after", None)]
    assert inner.parent == outer.id == 0 and rec.spans[3].id == 3
    assert all(s.host_ms >= 0 for s in rec.spans)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    summary = rec.summary()
    assert summary["counters"] == {"n": 5}
    assert nested.summary()["counters"] == {"n": 100}
    inner_sum = summary["spans"]["inner"]
    assert inner_sum["calls"] == 2 and inner_sum["device_ms"] is None
    assert inner_sum["host_ms"] == pytest.approx(
        inner_sum["host_ms_total"] / 2)
    assert set(summary["spans"]) == {"outer", "inner", "after"}


@pytest.mark.parametrize("make", [_sbp, _spm], ids=["sbp", "spm"])
def test_train_step_spans_and_markers(make):
    marks = []
    with tracing.recording("cpu") as rec:
        loss = _run(make, lambda name: marks.append(
            (name, _last_ended(rec))))
    assert torch.isfinite(loss)
    top = rec.spans[0]
    assert top.name == "train.step" and top.parent is None
    assert [(s.name, s.parent) for s in rec.spans[1:]] == \
        [(n, top.id) for n in STEP_PARTS]
    ends = [s.end_ns for s in rec.spans[1:]]
    assert ends == sorted(ends) and top.end_ns >= ends[-1]
    # the benchmark's hook: the names and the order it had, each call
    # right after its span
    assert [m for m, _ in marks] == ["augment", "targets",
                                     "forward_backward", "optimizer"]
    assert all(MARKS[m] == ended for m, ended in marks)
    assert rec.summary()["spans"]["train.forward"]["calls"] == 1


def test_marker_without_recording_and_across_ranks(monkeypatch):
    """Off, the markers come as on; under two ranks (the collective
    stood in for) the all-reduce has its span and its marker."""
    marks = []
    _run(_sbp, marks.append)
    assert marks == ["augment", "targets", "forward_backward", "optimizer"]
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "average_gradients",
                        lambda params, *values: values)
    step, batch = _sbp()
    half = {k: v[:1] for k, v in batch.items()}
    marks = []
    with tracing.recording("cpu") as rec:
        step(half, torch.Generator().manual_seed(1),
             torch.Generator().manual_seed(1),
             marker=lambda name: marks.append((name, _last_ended(rec))))
    assert [m for m, _ in marks] == ["augment", "targets",
                                     "forward_backward", "all_reduce",
                                     "optimizer"]
    assert all(MARKS[m] == ended for m, ended in marks)
    assert [s.name for s in rec.spans[1:]] == STEP_PARTS[:5] + [
        "train.all_reduce", "train.optimizer"]


def test_classifier_step_spans_and_markers():
    model = TinyClassifier(5)
    step, _ = make_classifier_steps(model, _sgd(model), 5)
    images = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8)
    labels = torch.tensor([0, 1, 2, 3])
    marks = []
    with tracing.recording("cpu") as rec:
        step(images, labels, torch.Generator().manual_seed(0),
             marker=lambda name: marks.append((name, _last_ended(rec))))
    assert [s.name for s in rec.spans] == [
        "train.step", "train.draw", "train.forward", "train.backward",
        "train.optimizer"]
    assert [m for m, _ in marks] == ["forward_backward", "optimizer"]
    assert all(MARKS[m] == ended for m, ended in marks)


def test_profiler_trace_holds_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording("cpu"):
            _run(_sbp)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"pose.train.step"} | {"pose." + n for n in STEP_PARTS} <= ranges


def _arrays(n=10):
    rng = np.random.RandomState(3)
    return {"image": rng.randint(0, 256, (n, 4, 3, 3), dtype=np.uint8),
            "joints": rng.rand(n, K, 2).astype(np.float32),
            "joints_vis": rng.rand(n, K).astype(np.float32)}


def test_device_cache_spans_bytes_and_batches():
    arrays = _arrays()
    plain = DeviceDataCache(arrays, 4, seed=5, device="cpu")
    with tracing.recording("cpu") as rec:
        cache = DeviceDataCache(arrays, 4, seed=5, device="cpu")
        batches = list(cache.epoch_batches(1))
    order = np.random.RandomState((5 * 2654435761 + 97) % 2 ** 32) \
        .permutation(10)
    rows = cache.epoch_indices(1)
    assert len(batches) == cache.steps_per_epoch == len(rows) == 2
    for got, want, r in zip(batches, plain.epoch_batches(1), rows):
        for k in arrays:
            assert torch.equal(got[k], want[k])
            np.testing.assert_array_equal(got[k].numpy(),
                                          arrays[k][order][r])
    summary = rec.summary()
    assert summary["counters"] == {"setup.cache.bytes": cache.nbytes()}
    spans = summary["spans"]
    assert spans["setup.cache"]["calls"] == 1
    assert spans["setup.cache.order"]["calls"] == 1 + len(arrays)
    assert spans["setup.cache.upload"]["calls"] == len(arrays)
    assert spans["feed.gather"]["calls"] == 2
    top = rec.spans[0]
    assert top.name == "setup.cache" and {
        s.parent for s in rec.spans if s.name.startswith("setup.cache.")} \
        == {top.id}


def test_trainer_setup_model_span(monkeypatch):
    monkeypatch.setattr(trainer_mod, "build_model",
                        lambda cfg, kind: TinyPose(K))
    cfg = {"num_keypoints": K, "input_size": list(HW), "output_size":
           list(OUT), "sigma": 2.0, "conf_threshold": 0.25,
           "batch_size": B, "optimizer": "sgd",
           "optimizer_options": {"lr": 1e-3, "momentum": 0.9,
                                 "nesterov": True}}
    with tracing.recording("cpu") as rec:
        Trainer(cfg, None, logging=False, device="cpu")
    assert [s.name for s in rec.spans] == ["setup.model"]
    assert rec.summary()["spans"]["setup.model"]["calls"] == 1


def test_busy_union_counts_overlaps_once():
    assert busy_us([]) == 0.0
    assert busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert busy_us([(3, 4), (0, 1), (0, 1)]) == 2.0
