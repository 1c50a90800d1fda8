"""Serving cells: one client in a closed loop over the fused SBP predictor
(``load_sbp_predictor``: normalize, forward, the K2 decode), as
``inference_sbp.py`` calls it per crop.

Set-up makes a pool of uint8 crops and the order of the requests from the
seed, and weights whose BN running statistics are the batch statistics of
the pool's first crops (worked out by the reference model, so that the
logits have a served model's spread), hands the weights to
``load_sbp_predictor`` as a torch file held in memory, and warms up.  A
request runs from the host's crop [1, H, W, 3] to the joints back on the
host (``.cpu()``); its latency is taken by CUDA events recorded before the
call and after the copy back, on the device's clock.

No cell of ``BENCHMARK.json`` runs this entry yet: one crop a request
spreads too widely on a shared host to hold a bound (PERF.md, Open
questions); ``workloads/sbp_infer_b1.json`` is ready for the cell.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from posebench import harness, judge, trace, traffic, work

TRACE_PATH = harness.ROOT / "build" / "posebench" / "trace.json"
REF_BLOCK = 64


def port_config(config: dict, net) -> dict:
    """The predictor's configuration, with the keys that the network
    ``net`` adds (``port_keys``)."""
    cfg = {k: config[k] for k in net.port_keys if k in config}
    cfg.update(num_keypoints=config["num_keypoints"],
               precision=config["precision"],
               input_size=config["input_size"],
               conf_threshold=config["conf_threshold"], seed=0, remat=False)
    return cfg


@torch.no_grad()
def served_weights(cell: harness.Cell, crops: np.ndarray,
                   device: torch.device) -> dict:
    """Seeded weights with BN running statistics from the batch statistics
    of the first ``calibration`` crops (fp32 reference, TF32 off)."""
    weights = harness.cell_weights(cell, device)
    x = torch.from_numpy(crops[:int(cell.workload["calibration"])]).to(device)
    stats = {}
    with _no_tf32():
        cell.net.forward(weights, x.permute(0, 3, 1, 2).float() / 255.0,
                         cell.config, True, stats=stats)
    weights.update(stats)
    return weights


class _no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = self.saved


def load_predictor(cell: harness.Cell, weights: dict, device):
    """``load_sbp_predictor`` over ``weights``, passed as a torch file in
    an anonymous in-memory file."""
    from pytorch_pose_estimation_tpu_torch.train import load_sbp_predictor

    fd = os.memfd_create("posebench-weights")
    try:
        path = f"/proc/self/fd/{fd}"
        with open(path, "wb") as f:
            torch.save({k: v.cpu() for k, v in weights.items()}, f)
        return load_sbp_predictor(port_config(cell.config, cell.net), path,
                                  device)
    finally:
        os.close(fd)


class Clock:
    """Per-request latency: CUDA events on the card, the host clock on the
    CPU (tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, start) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((start, e))
        else:
            self.marks.append((start, time.perf_counter()))

    def ms(self) -> np.ndarray:
        if self.cuda:
            return np.array([a.elapsed_time(b) for a, b in self.marks])
        return np.array([(b - a) * 1e3 for a, b in self.marks])


def run(cell: harness.Cell, t_start: float) -> harness.Outcome:
    device = torch.device(cell.device)
    cfg, wl = cell.config, cell.workload
    crops, order = traffic.request_pool(cell.traffic, cfg, cell.seed)
    weights = served_weights(cell, crops, device)
    predict = load_predictor(cell, weights, device)
    del weights
    for i in range(int(wl["warmup_requests"])):
        predict(crops[order[i]]).cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    clock, served = Clock(device), []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < cell.seconds:
        ids = order[i % len(order)]
        i += 1
        start = clock.start()
        joints = predict(crops[ids]).cpu()
        clock.stop(start)
        served.append((ids, joints))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    lat = clock.ms()
    joints = torch.cat([j for _, j in served]).numpy()
    failed = int((~np.isfinite(joints)).any(axis=(1, 2)).sum())
    out = harness.Outcome(attempted=len(served), failed=failed)
    k = int(cfg["num_keypoints"])
    n = order.shape[1]
    oh, ow = (int(s) // 4 for s in cfg["input_size"])
    if cell.trace:
        from torch.profiler import record_function

        def requests():
            for j in range(int(wl["trace_requests"])):
                with record_function("predict"):
                    y = predict(crops[order[j % len(order)]])
                with record_function("to_host"):
                    y.cpu()

        reduced = trace.profile(requests, TRACE_PATH)
        out.measured = {
            "entry": "infer", "requests_per_s": len(served) / seconds,
            "flops_per_request": n * cell.net.forward_flops(cfg),
            "chips": cell.chips, "latency_ms": lat,
            "k2_bytes": work.sbp_decode_bytes(n, k, oh, ow),
            "ops": reduced["ops"], "busy_s": reduced["busy_s"],
            "window_s": reduced["window_s"]}
        out.busy_s, out.window_s = reduced["busy_s"], reduced["window_s"]
        out.breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}
    else:
        out.e2e = {"latency_p50_ms": float(np.percentile(lat, 50)),
                   "latency_p95_ms": float(np.percentile(lat, 95)),
                   "setup_s": setup_s}
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del predict
    out.checks = judge.checks(check(cell, crops, served, device),
                              wl["limits"])
    return out


def reference_logits(cell: harness.Cell, crops: np.ndarray, idx,
                     device, quant=None) -> np.ndarray:
    """The reference's fp32 logits of ``crops[idx]``, in blocks."""
    weights = served_weights(cell, crops, device)
    out = []
    with torch.no_grad(), _no_tf32():
        for s in range(0, len(idx), REF_BLOCK):
            x = torch.from_numpy(crops[idx[s:s + REF_BLOCK]]).to(device)
            out.append(cell.net.forward(
                weights, x.permute(0, 3, 1, 2).float() / 255.0, cell.config,
                False, quant).cpu())
    return torch.cat(out).numpy()


def sample(cell: harness.Cell, n_served: int) -> np.ndarray:
    """A seeded sample of the answered requests' positions."""
    rng = np.random.default_rng([cell.seed % (2 ** 63), 5])
    n = min(int(cell.workload["checked_requests"]), n_served)
    return np.sort(rng.choice(n_served, n, replace=False))


def check(cell, crops, served, device) -> dict:
    """The comparison's numbers over a seeded sample of ``served``
    ([(crop indices [n], joints [n, K, 3])])."""
    pick = sample(cell, len(served))
    idx = np.concatenate([served[i][0] for i in pick])
    joints = np.concatenate([served[i][1].numpy() for i in pick])
    logits = reference_logits(cell, crops, idx, device)
    return judge.infer_numbers(joints, logits,
                               int(cell.config["input_size"][1]),
                               float(cell.config["conf_threshold"]))
