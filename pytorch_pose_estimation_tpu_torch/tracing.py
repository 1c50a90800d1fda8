"""Spans and counters inside the port, on the profiler's clock.

``span(name)`` marks a stretch of the program and ``count(name, n)`` adds
to a counter.  Both do nothing until a ``recording()`` is open: then a
span keeps its name, its id and its parent's id, the host's
``perf_counter_ns`` at entry and exit, a ``torch.profiler.record_function``
range named ``"pose." + name`` (so that a profiler trace shows the span on
the timeline of the kernels it launched) and, on a CUDA device, a pair of
CUDA events on the current stream for its device time::

    from pytorch_pose_estimation_tpu_torch import tracing

    with tracing.recording() as rec:
        for batch in batches:
            trainer.train_step(batch, gen, host_gen)
    rec.summary()["spans"]["train.forward"]["device_ms"]

The names the port uses: ``train.step`` and its parts ``train.draw``,
``train.augment``, ``train.targets``, ``train.forward``,
``train.backward``, ``train.all_reduce`` (several ranks only) and
``train.optimizer``; ``feed.gather`` (a device cache's batch);
``setup.model`` (the Trainer's model, built and moved), ``setup.cache``
with its parts ``setup.cache.order`` and ``setup.cache.upload``, and the
counter ``setup.cache.bytes``.  A set-up span (``sync=True``) ends in a
synchronize while recording, so that a copy's completion falls inside it.

Off, a span costs one check of a module global and returns a shared no-op
object: no allocation, no profiler range, no CUDA event.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

_open: Optional["Recording"] = None  # the innermost open recording


class _Off:
    """The span of a program that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


@dataclass
class SpanRecord:
    """One span: ``parent`` is the enclosing span's ``id`` (None at the
    top); host times from ``time.perf_counter_ns``; ``end_ns`` is None
    while the span is open."""
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    events: Optional[tuple] = None  # (start, end) CUDA events

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Span:
    __slots__ = ("rec", "name", "sync", "record", "range")

    def __init__(self, rec: "Recording", name: str, sync: bool):
        self.rec, self.name, self.sync = rec, name, sync

    def __enter__(self):
        rec, stack = self.rec, self.rec._stack
        record = self.record = SpanRecord(
            len(rec.spans), stack[-1] if stack else None, self.name, 0)
        rec.spans.append(record)
        rec._stack.append(record.id)
        self.range = torch.profiler.record_function("pose." + record.name)
        self.range.__enter__()
        if rec.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            record.events = (start,)
        record.start_ns = time.perf_counter_ns()
        return record

    def __exit__(self, *exc):
        rec, record = self.rec, self.record
        if rec.cuda:
            if self.sync:
                torch.cuda.synchronize()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            record.events += (end,)
        record.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        rec._stack.pop()
        return False


def span(name: str, sync: bool = False):
    """A context manager over a part of the program named ``name``;
    ``sync``: end in a device synchronize (set-up spans)."""
    if _open is None:
        return _OFF
    return _Span(_open, name, sync)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open recording."""
    if _open is not None:
        _open.counters[name] = _open.counters.get(name, 0) + n


class Recording:
    """What the program's spans and counters recorded while it was open.
    ``device``: CUDA events are recorded where it is a CUDA device (the
    default: where CUDA is available)."""

    def __init__(self, device=None):
        if device is None:
            self.cuda = torch.cuda.is_available()
        else:
            self.cuda = torch.device(device).type == "cuda"
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self._stack: List[int] = []
        self._outer: Optional[Recording] = None

    def start(self) -> "Recording":
        global _open
        self._outer, _open = _open, self
        return self

    def stop(self) -> None:
        global _open
        _open = self._outer

    def __enter__(self) -> "Recording":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self) -> dict:
        """``{"spans": {name: {calls, host_ms, host_ms_total, device_ms}},
        "counters": {name: total}}`` over the closed spans; ``host_ms`` and
        ``device_ms`` are means a call, ``device_ms`` None without CUDA.
        Synchronizes once."""
        if self.cuda:
            torch.cuda.synchronize()
        spans: Dict[str, dict] = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            out = spans.setdefault(s.name, {"calls": 0, "host_ms_total": 0.0,
                                            "device_ms_total": 0.0})
            out["calls"] += 1
            out["host_ms_total"] += s.host_ms
            if self.cuda:
                out["device_ms_total"] += s.events[0].elapsed_time(
                    s.events[1])
        for out in spans.values():
            out["host_ms"] = out["host_ms_total"] / out["calls"]
            total = out.pop("device_ms_total")
            out["device_ms"] = total / out["calls"] if self.cuda else None
        return {"spans": spans, "counters": dict(self.counters)}


def recording(device=None) -> Recording:
    """A ``Recording`` to open with ``with``: spans and counters record
    into it until it closes (see ``Recording``)."""
    return Recording(device)
