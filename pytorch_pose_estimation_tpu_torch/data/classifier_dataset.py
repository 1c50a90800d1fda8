"""ImageFolder-style classification data for the darknet19 backbone
pretrain (the reference consumes a tiny-imagenet classifier checkpoint,
models/backbone/darknet.py:138-150; ``train_classifier`` makes one).

Counterpart of pytorch_pose_estimation_tpu/data/classifier_dataset.py:
``<dir>/<class name>/<image>``; the labels are the index of the class
directory in sorted order (torchvision ImageFolder), the classes come from
the train directory, and a val directory may lack some of them.  Each image
is read with cv2 (imported where an image is read), converted to RGB and
resized to ``input_size`` square; a file cv2 cannot read raises IOError.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .pipeline import HostLoader

_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def _scan(root: str, classes: List[str]) -> List[dict]:
    db = []
    for label, name in enumerate(classes):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue  # a val directory may lack some classes
        for fname in sorted(os.listdir(d)):
            if os.path.splitext(fname)[1].lower() in _EXTS:
                db.append({"path": os.path.join(d, fname), "label": label})
    return db


class ImageFolderDataModule:
    """Train and val records and their host loaders; batches hold image
    uint8 [B, S, S, 3] and label int32 [B]."""

    def __init__(self, train_dir: str, val_dir: Optional[str],
                 input_size: int, workers: int, batch_size: int,
                 seed: int = 0):
        self.train_dir = train_dir
        self.val_dir = val_dir
        self.input_size = int(input_size)
        self.workers = int(workers)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        # this process's train shard, as the pose data modules'
        self.process_index = 0
        self.process_count = 1
        self.classes: List[str] = []
        self.train_db: List[dict] = []
        self.val_db: List[dict] = []

    def setup(self):
        self.classes = sorted(
            d for d in os.listdir(self.train_dir)
            if os.path.isdir(os.path.join(self.train_dir, d)))
        self.train_db = _scan(self.train_dir, self.classes)
        if self.val_dir and os.path.isdir(self.val_dir):
            self.val_db = _scan(self.val_dir, self.classes)

    def _sample(self, rec: dict, index: int, epoch: int) -> dict:
        import cv2

        s = self.input_size
        raw = cv2.imread(rec["path"])
        if raw is None:
            raise IOError(f"cv2.imread failed (corrupt/unreadable image): "
                          f"{rec['path']}")
        img = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        return {"image": img, "label": np.int32(rec["label"])}

    def _loader(self, db, train: bool, batch_size=None) -> HostLoader:
        shard = (self.process_index, self.process_count) if train else (0, 1)
        return HostLoader(db, self._sample,
                          batch_size=batch_size or self.batch_size,
                          shuffle=train, seed=self.seed, drop_last=train,
                          workers=self.workers, process_index=shard[0],
                          process_count=shard[1])

    def train_loader(self, batch_size=None) -> HostLoader:
        return self._loader(self.train_db, True, batch_size)

    def val_loader(self, batch_size=None) -> HostLoader:
        return self._loader(self.val_db, False, batch_size)
