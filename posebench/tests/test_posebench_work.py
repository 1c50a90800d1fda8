"""The yardstick's arithmetic against torch's FLOP counter and hand
counts, and the trace's reduction on events made by hand."""

import pytest

from posebench import harness, trace, work
from posebench_tiny import flops_counted

NET = harness.network({})   # the default network: Darknet19's


def config(kind, hw):
    return {"kind": kind, "input_size": list(hw), "num_keypoints": 17,
            "init": {"bn_shift": 0.0}}


@pytest.mark.parametrize("kind,hw", [("sbp", (256, 192)), ("spm", (512, 512)),
                                     ("sbp", (64, 32))])
def test_flops_match_torch_counter(kind, hw):
    cfg = config(kind, hw)
    assert flops_counted(NET, cfg) == (NET.forward_flops(cfg),
                                       NET.train_flops(cfg))


def test_published_counts():
    sbp, spm = config("sbp", (256, 192)), config("spm", (512, 512))
    assert work.parameter_count("sbp", 17) == 36_606_368
    assert round(NET.forward_flops(sbp) / 1e9, 2) == 14.28
    assert NET.train_flops(sbp) == 42_759_880_704
    assert round(NET.forward_flops(spm) / 1e9, 2) == 76.47
    assert NET.train_flops(spm) == 228_958_666_752
    w = NET.weights(sbp, 0, "cpu")
    n = sum(w[k].numel() for k in NET.groups(sbp))
    assert n == work.parameter_count("sbp", 17)


@pytest.mark.parametrize("kind,hw,elements", [
    ("sbp", (256, 192), 6_488_064), ("spm", (512, 512), 34_603_008)])
def test_bn_act_elements_by_hand(kind, hw, elements):
    """Each BN + ReLU layer's output, channels x height x width: the 18
    convolutions at their stage's scale, the three deconvolutions at 512
    channels from 1/16 to 1/4 of the input."""
    h, w = hw
    stages = [(32,), (64,), (128, 64, 128), (256, 128, 256),
              (512, 256, 512, 256, 512), (1024, 512, 1024, 512, 1024)]
    convs = sum(c * (h >> s) * (w >> s)
                for s, cs in enumerate(stages) for c in cs)
    deconvs = sum(512 * (h >> s) * (w >> s) for s in (4, 3, 2))
    assert convs + deconvs == elements == NET.bn_act_elements(
        config(kind, hw))
    assert work.bn_act_bytes(elements) == 16 * elements


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


def test_k3_roofline_by_hand():
    """K3's six kernels summed over the profiled steps; cuDNN's and torch's
    BN kernels, whose names also hold "bn_", are not K3's."""
    read = harness.metric_reader("k3_roofline.train")
    k3_bytes = work.bn_act_bytes(256 * 6_488_064)   # SBP at batch 256
    k3 = {"void bn_stats_kernel<8>(Plan, unsigned short const*, float*)":
          [1.4e-3, 1.4e-3],
          "void bn_finalize_kernel(int, int, float const*, float*)":
          [0.05e-3, 0.05e-3],
          "void (anonymous namespace)::bn_apply_kernel<8, true>(Plan)":
          [2.25e-3, 2.25e-3],
          "void bn_grad_sums_kernel<8, true>(Plan)": [2.8e-3, 2.8e-3],
          "void bn_grad_finalize_kernel(int, int, float)":
          [0.05e-3, 0.05e-3],
          "void bn_grad_apply_kernel<1, false>(Plan)": [3.55e-3, 3.55e-3]}
    others = {"void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(float)": [9e-3],
              "void cudnn::bn_bw_1C11_kernel_new<float>(float)": [9e-3],
              "void at::native::batch_norm_collect_statistics_kernel()":
              [9e-3],
              "void my_bn_stats_kernel_v2<8>(Plan)": [9e-3]}
    measured = {"entry": "train", "k3_bytes": k3_bytes, "trace_steps": 2,
                "ops": {**k3, **others}}
    # 26.57 GB at 3.35 TB/s is 7.932 ms; 10.1 ms a step of K3 is 78.5%
    assert read(measured) == pytest.approx(78.543, rel=1e-4)
    assert read(dict(measured, ops=others)) is None
    assert read(dict(measured, entry="infer")) is None
    assert read({k: v for k, v in measured.items() if k != "k3_bytes"}) \
        is None
