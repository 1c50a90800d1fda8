"""Host-side batch loader.

Counterpart of pytorch_pose_estimation_tpu/data/pipeline.py (``collate``,
``pad_batch``, ``HostLoader``): a thread pool builds samples and one
background thread prefetches batches while the device runs.  cv2 releases
the GIL, so threads parallelize the decode work.  With a ``batch_fn`` (the
native loader's path) one call builds the whole batch on the C++ thread
pool, and there is no Python thread pool.

Determinism, as in the JAX package: ``shuffle`` permutes the records with
``np.random.RandomState((seed * 1000003 + epoch) % 2**32)``, so both
packages' loaders yield the same instances in the same order for a seed and
an epoch.

Data parallelism (``parallel``) takes one of two forms here:

* on several nodes, each process loads its own shard of the records,
  ``indices[process_index::process_count]`` after the shared permutation,
  padded by wraparound to equal lengths (torch's DistributedSampler
  semantics, the JAX package's ``_indices``);
* on one node, every rank walks the same global batches and builds only
  its rows of each (``split_rows``), as the JAX mesh splits a host's
  global batch into contiguous rows.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

_PREFETCH = 2  # batches built ahead of the consumer


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of per-sample dicts into one batch dict of arrays."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples], axis=0)
    return out


def pad_batch(batch: dict, size: int) -> dict:
    """Zero-pad every batch array up to ``size`` rows and attach a
    ``pad_mask`` (1 = real row)."""
    n = len(next(iter(batch.values())))
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        if n < size:
            pad = np.zeros((size - n,) + value.shape[1:], value.dtype)
            value = np.concatenate([value, pad], axis=0)
        out[key] = value
    mask = np.zeros((size,), np.int32)
    mask[:n] = 1
    out["pad_mask"] = mask
    return out


class HostLoader:
    """Iterable batch loader over a record list;
    ``sample_fn(record, index, epoch) -> dict of arrays`` builds one
    sample (``index`` is the record's position in ``db``), or
    ``batch_fn(records, indices, epoch) -> batch dict`` builds a whole
    batch."""

    def __init__(self, db: Sequence, sample_fn: Optional[Callable],
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, workers: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 batch_fn: Optional[Callable] = None):
        if sample_fn is None and batch_fn is None:
            raise ValueError("HostLoader needs a sample_fn or a batch_fn")
        self.db = db
        self.sample_fn = sample_fn
        self.batch_fn = batch_fn
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed or 0)
        self.drop_last = drop_last
        self.workers = max(int(workers), 0)
        self.process_index = int(process_index)
        self.process_count = max(int(process_count), 1)
        self.epoch = 0
        self._rows = (0, 1)  # (rank, world) of split_rows

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def split_rows(self, rank: int, world: int) -> "HostLoader":
        """Build only rows ``rank*b:(rank+1)*b`` of every batch, b =
        batch_size / world; the batches and their order are unchanged.
        Needs ``drop_last`` (every batch full) and world | batch_size."""
        if world > 1 and not self.drop_last:
            raise ValueError("split_rows needs drop_last: a ragged last "
                             "batch does not split into equal rows")
        if self.batch_size % world:
            raise ValueError(f"batch {self.batch_size} is not divisible by "
                             f"the {world} ranks")
        self._rows = (int(rank), int(world))
        return self

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.db))
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch) % (2 ** 32))
            idx = rng.permutation(idx)
        if self.process_count > 1 and len(idx):
            # DistributedSampler semantics: pad by wraparound, so that every
            # process runs the same number of steps (an unequal count would
            # leave a rank waiting in a collective)
            target = -(-len(idx) // self.process_count) * self.process_count
            if target > len(idx):
                idx = np.concatenate([idx, idx[:target - len(idx)]])
        return idx[self.process_index::self.process_count]

    def _batches(self) -> List[np.ndarray]:
        idx = self._indices()
        rank, world = self._rows
        b = self.batch_size // world
        out = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            out.append(chunk[rank * b:(rank + 1) * b] if world > 1
                       else chunk)
        return out

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _build(self, chunk: np.ndarray, epoch: int, pool) -> dict:
        if self.batch_fn is not None:
            return self.batch_fn([self.db[i] for i in chunk], chunk, epoch)
        args = [(self.db[i], int(i), epoch) for i in chunk]
        if pool is not None:
            return collate(list(pool.map(lambda a: self.sample_fn(*a),
                                         args)))
        return collate([self.sample_fn(*a) for a in args])

    def __iter__(self):
        batches = self._batches()
        epoch = self.epoch
        if not batches:
            return iter(())

        pool = ThreadPoolExecutor(self.workers) if self.workers > 1 and \
            self.batch_fn is None else None
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
                for chunk in batches:
                    if abandoned.is_set():
                        return
                    if not _put(self._build(chunk, epoch, pool)):
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
