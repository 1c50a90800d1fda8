"""Device-resident training-set cache (``cache_device: true``).

Counterpart of pytorch_pose_estimation_tpu/train/device_cache.py.  Every
randomized augmentation runs in the train step on the device, so the
host's product per instance is a deterministic uint8 crop, and the whole
training set can live in device memory: a 256x192 crop is 147 KB, the
reference's 64,115-instance COCO train split about 9.4 GB, well inside an
H100's 80 GB.  After one upload, a step's feed is one ``index_select`` per
array on the device; the host loader and the host-to-device copy leave the
hot loop.

The order equals the JAX package's ``DeviceDataCache`` on a mesh of as
many devices as there are ranks, index for index.  The instances are
permuted once with ``RandomState((seed * 2654435761 + 97) % 2**32)`` and
padded by wraparound to a multiple of the D ranks; rank r holds only the
r-th contiguous shard of n/D instances, on its own device.  Every epoch
``RandomState((seed * 1000003 + epoch) % 2**32)`` draws one permutation
inside each shard, cut into steps of pb = B/D rows (the ragged tail
dropped): JAX's [S, D*pb] index matrix, of which rank r gathers columns
``r*pb:(r+1)*pb`` from its shard.  With one rank this is one permutation
of the whole set.

Not ported: the JAX package's ``make_epoch_runner`` (a ``lax.scan`` over
an epoch, in chunks of ``scan_steps_per_dispatch``) and its ``shard_map``
gather.  They exist for the TPU's dispatch cost and its execution watchdog;
the JAX package's own tests show that the per-step path lands on the same
parameters.  The port's ``Trainer`` accepts ``cache_scan`` and
``scan_steps_per_dispatch`` and ignores them.

``build_device_cache`` decodes the train set once, with val semantics, and
memoizes the arrays on disk in ``<train_path>.devcache/`` (one ``.npy`` per
key and a ``meta.json``), in the JAX package's format: either package reads
the other's memo.  Under several ranks, rank 0 decodes and writes the memo
while the others wait at a barrier, then read it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..tracing import count, span

_MEMO_VERSION = 1


class DeviceDataCache:
    """Rank ``rank``'s shard of the train arrays, held on ``device`` and
    served as per-epoch batches of its ``batch_size / world`` rows,
    gathered there.

    arrays: dict of [N, ...] host numpy arrays (the same N).  The leading
    axis is permuted once by ``seed`` and padded by wraparound to a
    multiple of ``world``; the rank uploads its contiguous shard.

    Under a ``tracing.recording()`` the construction is the span
    ``setup.cache``, over ``setup.cache.order`` (the permutation, and each
    array's shard copied in that order on the host) and
    ``setup.cache.upload`` (each copy to the device), with the counter
    ``setup.cache.bytes``; a batch's gather is ``feed.gather``."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, device="cuda", rank: int = 0,
                 world: int = 1):
        with span("setup.cache", sync=True):
            self._build(arrays, batch_size, seed, device, rank, world)

    def _build(self, arrays, batch_size, seed, device, rank, world) -> None:
        names = sorted(arrays)
        n = len(arrays[names[0]])
        if n == 0:
            raise ValueError("empty dataset")
        self.batch_size = int(batch_size)
        self.rank, self.world = int(rank), int(world)
        self.per_device_batch = mesh.per_rank(self.batch_size, self.world)
        self.seed = int(seed)
        self.device = torch.device(device)
        self._names = names
        # one global permutation, so that the order does not follow the
        # annotation file's
        with span("setup.cache.order"):
            rng = np.random.RandomState((seed * 2654435761 + 97) % (2 ** 32))
            order = rng.permutation(n)
            n_pad = -(-n // self.world) * self.world
            if n_pad > n:
                order = np.concatenate([order, order[:n_pad - n]])
        self.n_total = n_pad
        self.n_local = n_pad // self.world
        if self.per_device_batch > self.n_local:
            raise ValueError(f"per-device batch {self.per_device_batch} "
                             f"exceeds the {self.n_local}-instance device "
                             f"shard")
        self.steps_per_epoch = self.n_local // self.per_device_batch
        shard = order[self.rank * self.n_local:(self.rank + 1) * self.n_local]
        self._data = {}
        for k in names:  # one host copy alive at a time
            with span("setup.cache.order"):
                host = np.ascontiguousarray(arrays[k][shard])
            with span("setup.cache.upload", sync=True):
                self._data[k] = torch.from_numpy(host).to(self.device)
            del host
            count("setup.cache.bytes",
                  self._data[k].numel() * self._data[k].element_size())

    def nbytes(self) -> int:
        """The bytes this rank holds on its device."""
        return sum(t.numel() * t.element_size() for t in self._data.values())

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """[steps_per_epoch, batch] int32 shard-local row indices of one
        epoch, the JAX package's: a permutation inside each of the D
        shards, cut into steps (drop_last, as the host train loader); row
        s, columns d*pb:(d+1)*pb are device (rank) d's rows of step s."""
        rng = np.random.RandomState(
            (self.seed * 1000003 + int(epoch)) % (2 ** 32))
        perms = np.stack([rng.permutation(self.n_local)
                          for _ in range(self.world)])  # [D, n_local]
        pb = self.per_device_batch
        cut = perms[:, :self.steps_per_epoch * pb].reshape(
            self.world, self.steps_per_epoch, pb)
        return cut.transpose(1, 0, 2).reshape(
            self.steps_per_epoch, self.batch_size).astype(np.int32)

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yields ``steps_per_epoch`` batch dicts of this rank's rows (its
        columns of ``epoch_indices``), on its device, each gathered there
        by one ``index_select`` per array."""
        pb = self.per_device_batch
        cols = self.epoch_indices(epoch)[:, self.rank * pb:
                                         (self.rank + 1) * pb]
        idx = torch.from_numpy(cols.astype(np.int64)).to(self.device)
        for rows in idx:
            with span("feed.gather"):
                batch = {k: torch.index_select(self._data[k], 0, rows)
                         for k in self._names}
            yield batch


def _disk_cache_dir(data_module) -> str | None:
    """``<train_path>.devcache``, or None when the data module has no
    train annotation file to anchor it."""
    ann = getattr(data_module, "train_path", None)
    if not ann or not os.path.exists(ann):
        return None
    return ann + ".devcache"


def _disk_cache_meta(data_module, keys: Sequence[str], n: int) -> dict:
    """The memo's identity, the JAX package's fields: the annotation file's
    mtime and size, the crop size, the count and the keys."""
    ann = data_module.train_path
    size = data_module.input_size
    return {
        "version": _MEMO_VERSION,
        "ann_mtime": os.path.getmtime(ann),
        "ann_size": os.path.getsize(ann),
        "input_size": list(size) if isinstance(size, (list, tuple))
        else int(size),
        "n": int(n),
        "keys": sorted(keys),
    }


def _read_memo(cache_dir: str, data_module, keys: Sequence[str]):
    """The memo's arrays when its meta matches, else None."""
    try:
        with open(os.path.join(cache_dir, "meta.json")) as f:
            meta = json.load(f)
        if meta != _disk_cache_meta(data_module, keys,
                                    len(data_module.train_db)):
            return None
        return {k: np.load(os.path.join(cache_dir, k + ".npy"))
                for k in keys}
    except (OSError, ValueError, KeyError):
        return None  # unreadable or stale: decode again


def _write_memo(cache_dir: str, data_module, keys: Sequence[str],
                arrays: Dict[str, np.ndarray]) -> None:
    try:
        tmp = cache_dir + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for k in keys:
            np.save(os.path.join(tmp, k + ".npy"), arrays[k])
        meta = _disk_cache_meta(data_module, keys, len(arrays[keys[0]]))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(cache_dir):
            shutil.rmtree(cache_dir)
        os.replace(tmp, cache_dir)
    except OSError as e:
        print(f"devcache: disk memoization skipped ({e})")


def build_device_cache(data_module, batch_size: int, seed: int = 0,
                       keys: Sequence[str] = ("image", "joints",
                                              "joints_vis"),
                       disk_cache: bool = True,
                       device="cuda") -> DeviceDataCache:
    """Decode every train instance once through the data module's loader
    (the native loader when it is in use) and upload the stacked arrays.
    ``keys`` are the batch fields of the model kind (SBP and PIS: image,
    joints, joints_vis; SPM: image, joints, centers).

    The loader runs with val semantics (no shuffle, no host CLAHE, no
    drop_last): the crop is deterministic, and the random CLAHE runs on
    the device, where it draws anew every epoch; a host CLAHE baked into
    the cache would freeze one draw for the whole run.  It reads and fills
    no ``cache_images`` cache: the val loader's is keyed by position in
    ``val_db``, and train crops there would stand in for val images.

    The decoded arrays are memoized in ``<train_path>.devcache/`` (see the
    module docstring) unless ``disk_cache`` is False; a memo whose meta
    does not match the annotation file, the crop size, the count or the
    keys is decoded again.  Under several ranks, rank 0 reads or writes
    the memo first and the others read it after a barrier (decoding only
    where they find none); each rank uploads its own shard."""
    keys = tuple(keys)
    cache_dir = _disk_cache_dir(data_module) if disk_cache else None
    arrays = None
    if not mesh.is_main():
        mesh.barrier()  # rank 0 has the memo written
    if cache_dir:
        arrays = _read_memo(cache_dir, data_module, keys)
    if arrays is None:
        arrays = _decode(data_module, keys, batch_size)
        if cache_dir and mesh.is_main():
            _write_memo(cache_dir, data_module, keys, arrays)
    if mesh.is_main():
        mesh.barrier()
    return DeviceDataCache(arrays, batch_size, seed=seed, device=device,
                           rank=mesh.rank(), world=mesh.world_size())


def _decode(data_module, keys: Sequence[str], batch_size: int
            ) -> Dict[str, np.ndarray]:
    """The train set through the loader with val semantics, stacked."""
    loader = data_module._loader(data_module.train_db, train=False,
                                 batch_size=batch_size)
    parts: Dict[str, list] = {k: [] for k in keys}
    for batch in loader:
        for k in keys:
            parts[k].append(batch[k])
    return {k: np.concatenate(parts[k], axis=0) for k in keys}
