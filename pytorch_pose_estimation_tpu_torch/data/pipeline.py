"""Host-side batch loader.

Counterpart of pytorch_pose_estimation_tpu/data/pipeline.py (``collate``,
``HostLoader``): a thread pool builds samples and one background thread
prefetches batches while the device runs.  cv2 releases the GIL, so threads
parallelize the decode work.  Batches come in record order; shuffling, the
native whole-batch path (``batch_fn``) and the per-process shards come
with the slices that use them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np

_PREFETCH = 2  # batches built ahead of the consumer


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of per-sample dicts into one batch dict of arrays."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples], axis=0)
    return out


class HostLoader:
    """Iterable batch loader over a record list;
    ``sample_fn(record) -> dict of arrays`` builds one sample."""

    def __init__(self, db: Sequence, sample_fn: Callable, batch_size: int,
                 workers: int = 0):
        self.db = db
        self.sample_fn = sample_fn
        self.batch_size = int(batch_size)
        self.workers = max(int(workers), 0)

    def _batches(self) -> List[Sequence]:
        return [self.db[i:i + self.batch_size]
                for i in range(0, len(self.db), self.batch_size)]

    def __len__(self) -> int:
        return -(-len(self.db) // self.batch_size)

    def _build(self, records: Sequence, pool) -> dict:
        if pool is not None:
            return collate(list(pool.map(self.sample_fn, records)))
        return collate([self.sample_fn(r) for r in records])

    def __iter__(self):
        batches = self._batches()
        if not batches:
            return iter(())

        pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        _SENTINEL = object()
        abandoned = threading.Event()

        def _put(item) -> bool:
            # bounded-blocking put so an abandoned consumer (early break /
            # GC'd generator) never leaves the producer stuck on a full queue
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for records in batches:
                    if abandoned.is_set():
                        return
                    if not _put(self._build(records, pool)):
                        return
            except BaseException as exc:  # surfaced in the consumer
                _put(exc)
            finally:
                _put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)

        def gen():
            # the producer starts on the first next(): an iterator that is
            # never consumed leaves no thread behind
            thread.start()
            try:
                while True:
                    item = q.get()
                    if item is _SENTINEL:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                abandoned.set()
                thread.join()
                if pool is not None:
                    pool.shutdown(wait=False)

        return gen()
