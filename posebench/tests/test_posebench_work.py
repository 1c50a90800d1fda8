"""The yardstick's arithmetic against torch's FLOP counter and hand
counts, and the trace's reduction on events made by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from posebench import harness, trace, work
from posebench.reference import model


@pytest.mark.parametrize("kind,hw", [("sbp", (256, 192)), ("spm", (512, 512)),
                                     ("sbp", (64, 32))])
def test_flops_match_torch_counter(kind, hw):
    w = model.make_weights(kind, 17, 0, "cpu")
    keys = model.parameter_keys(kind, 17)
    leaves = [w[k].requires_grad_() for k in keys]
    x = torch.rand(1, 3, *hw)
    with FlopCounterMode(display=False) as fwd:
        y = model.forward(w, x, kind, 17, True)
    assert fwd.get_total_flops() == work.forward_flops(kind, hw, 17)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(y.square().sum(), leaves)
    assert fwd.get_total_flops() + bwd.get_total_flops() == \
        work.train_flops(kind, hw, 17)


def test_published_counts():
    assert work.parameter_count("sbp", 17) == 36_606_368
    assert round(work.forward_flops("sbp", (256, 192), 17) / 1e9, 2) == 14.28
    assert round(work.train_flops("sbp", (256, 192), 17) / 1e9, 2) == 42.76
    assert round(work.forward_flops("spm", (512, 512), 17) / 1e9, 2) == 76.47
    assert round(work.train_flops("spm", (512, 512), 17) / 1e9, 2) == 228.96
    w = model.make_weights("sbp", 17, 0, "cpu")
    n = sum(w[k].numel() for k in model.parameter_keys("sbp", 17))
    assert n == work.parameter_count("sbp", 17)


def test_kernel_bytes_by_hand():
    # K1 at B=256: 256*17*2 joints and 256*17*64*48 maps, 4 bytes each
    assert work.sbp_heatmap_bytes(256, 17, 64, 48) == \
        256 * 17 * 2 * 4 + 256 * 17 * 3072 * 4 == 53_512_192
    assert work.sbp_decode_bytes(1, 17, 64, 48) == 17 * 3072 * 4 + 17 * 12
    # 53.5 MB at 3.35 TB/s is 15.97 us; taking 20 us is 79.9%
    assert work.roofline_percent(53_512_192, 20e-6) == \
        pytest.approx(100 * 15.973e-6 / 20e-6, rel=1e-4)
    assert work.mfu_percent(42.76e9, 1000.0) == \
        pytest.approx(100 * 42.76e12 / 989e12)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction_by_hand():
    events = [ev("user_annotation", trace.WINDOW, 0, 100),
              ev("user_annotation", "feed", 0, 20),
              ev("user_annotation", "train_step", 20, 80),
              ev("kernel", "sbp_heatmaps_kernel", 10, 10),
              ev("kernel", "cudnn_convolve_x", 15, 10),   # overlaps: once
              ev("gpu_memcpy", "Memcpy HtoD", 50, 5),
              ev("gpu_user_annotation", "train_step", 20, 80),
              ev("kernel", "sbp_heatmaps_kernel", 90, 20)]  # cut at 100
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((25 - 10 + 5 + 10) * 1e-6)
    gaps = dict((round(s * 1e6), n) for n, s in r["idle_gaps"])
    assert gaps == {10: "feed", 25: "train_step", 35: "train_step"}
    assert trace.seconds_per_call(r["ops"], "sbp_heatmaps") == \
        pytest.approx(10e-6)
    assert r["device_ops"][0] == ["K1", pytest.approx(20e-6)]


def test_metric_readers_by_hand():
    measured = {"entry": "train", "images_per_s": 1000.0,
                "flops_per_image": 42.76e9, "chips": 1,
                "event_ms": {"gather": 0.1, "augment": 20.0},
                "ops": {"sbp_heatmaps_kernel": [20e-6, 20e-6]},
                "k1_bytes": 53_512_192, "busy_s": 0.97, "window_s": 1.0}
    read = {n: harness.metric_reader(n) for n in (
        "gather_ms.train", "augment_ms.train", "allreduce_ms.train",
        "k1_roofline.train", "idle_share.train", "mfu.train",
        "k2_roofline.infer", "mfu.infer")}
    assert read["gather_ms.train"](measured) == 0.1
    assert read["allreduce_ms.train"](measured) is None
    assert read["k1_roofline.train"](measured) == pytest.approx(79.869,
                                                                rel=1e-4)
    assert read["idle_share.train"](measured) == pytest.approx(3.0)
    assert read["mfu.train"](measured) == pytest.approx(4.3236, rel=1e-4)
    assert read["k2_roofline.infer"](measured) is None
    assert read["mfu.infer"](measured) is None
    no_k1 = dict(measured, ops={"other": [1e-3]})
    assert read["k1_roofline.train"](no_k1) is None
