"""A short steady sub-window under ``torch.profiler``, reduced to numbers.

The profiled window is the host's ``posebench.window`` range, which ends
in a synchronize, so the device's work lies inside it.  Busy time is the
union of the device's operation intervals (kernels, copies, sets): two
operations that overlap count once.  Idle gaps are the stretches of the
window that no operation covers, each named by the innermost of the
harness's host ranges (``feed``, ``train_step``, ``predict``,
``to_host``) open when it began.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Tuple

WINDOW = "posebench.window"
LABELS = ("feed", "train_step", "predict", "to_host")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name fragment -> kind, first match wins
KINDS = (("sbp_heatmaps", "K1"), ("decode_sbp", "K2"),
         ("implicit_gemm", "convolution"), ("convolve", "convolution"),
         ("conv", "convolution"), ("gemm", "matmul"),
         ("nchwtonhwc", "layout transpose"),
         ("nhwctonchw", "layout transpose"), ("bn_", "batch norm"),
         ("batch_norm", "batch norm"), ("max_pool", "max pool"),
         ("memcpy", "copy / cast"), ("memset", "memset"),
         ("copy", "copy / cast"), ("reduce", "reduction"),
         ("index", "index / scatter / gather"),
         ("gather", "index / scatter / gather"),
         ("scatter", "index / scatter / gather"),
         ("elementwise", "elementwise"))

Span = Tuple[float, float, str]


def kind(name: str) -> str:
    low = name.lower()
    for fragment, k in KINDS:
        if fragment in low:
            return k
    return "other"


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def reduce(events: List[dict]) -> Dict[str, object]:
    """Chrome-trace events -> busy_s, window_s, device_ops, idle_gaps and
    each device operation's durations by name (``ops``)."""
    device: List[Span] = []
    ranges: List[Span] = []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        start = float(e["ts"]) * 1e-6
        end = start + float(e.get("dur", 0.0)) * 1e-6
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            device.append((start, end, name))
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (start, end)
            elif name in LABELS:
                ranges.append((start, end, name))
    if window is None:
        raise ValueError(f"no {WINDOW} range in the trace")
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    busy = union([(a, b) for a, b, _ in inside])
    busy_s = sum(b - a for a, b in busy)
    ops: Dict[str, List[float]] = {}
    by_kind: Dict[str, float] = {}
    for a, b, n in inside:
        ops.setdefault(n, []).append(b - a)
        by_kind[kind(n)] = by_kind.get(kind(n), 0.0) + (b - a)
    gaps, at = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)

    def label(t: float) -> str:
        open_ = [(b - a, n) for a, b, n in ranges if a <= t < b]
        return min(open_)[1] if open_ else "other"

    idle = sorted(((label(a), b - a) for a, b in gaps),
                  key=lambda x: -x[1])
    return {"busy_s": busy_s, "window_s": w1 - w0, "ops": ops,
            "device_ops": [[k, v] for k, v in sorted(
                by_kind.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def profile(fn: Callable[[], None], path: Path) -> Dict[str, object]:
    """Run ``fn`` (which synchronizes the device at its end) under the
    profiler and reduce its trace, written to ``path`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, \
        record_function

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return reduce(events)


def seconds_per_call(ops: Dict[str, List[float]], fragment: str):
    """Mean duration of the device operations whose name holds
    ``fragment``, or None when none ran."""
    times = [t for name, ts in ops.items() if fragment in name for t in ts]
    return sum(times) / len(times) if times else None
