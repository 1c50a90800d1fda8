"""SBP (top-down, one sample per person instance) COCO data layer.

Counterpart of pytorch_pose_estimation_tpu/data/sbp_dataset.py: the host
decodes the JPEG, crops the clean GT bbox, resizes it to the model input
and ships uint8 pixels plus joint metadata; the random augmentation and
the targets run on the device (``ops/``).  Two decoders, chosen by
``use_native`` as in the JAX package: the native C++ loader
(``native_loader``: one call decodes, crops and resizes a whole batch on a
C++ thread pool) when it is available and ``use_native`` is None or True,
else cv2 per sample.  The two agree to a mean absolute difference under 2
levels, not exactly.  The optional host CLAHE on train crops is
Albumentations' (LAB L channel, clip limit uniform in [1, 4], p=0.5 per
sample), drawn from a RandomState seeded by (seed, epoch, index) as in the
JAX package, on either path.  cv2 is imported where it is used, so the
package imports without it.

Annotation sanitization follows the reference rule for rule (reference:
dataset/sbp_coco_dataset.py:97-169):
* bbox clipped into the image, kept only if area > 0 and non-degenerate;
* persons only, instances with no labeled keypoints dropped;
* a keypoint is visible only if strictly inside the int-cast clean bbox;
* instances whose keypoints are all invisible are dropped.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native_loader
from .coco import CocoAnnotations
from .pipeline import HostLoader, collate


def coco_img_dir(img_dir: str, ann_path: str) -> str:
    """Split image directory from the annotation filename, e.g.
    person_keypoints_val2017.json -> <img_dir>/val2017
    (reference: dataset/sbp_coco_dataset.py:85-89)."""
    split = os.path.splitext(ann_path.split("_")[-1])[0]
    return os.path.join(img_dir, split)


def sanitize_bbox(bbox, width: int, height: int) -> Optional[List[float]]:
    """Clip a COCO [x, y, w, h] bbox into the image; None if degenerate
    (reference: dataset/sbp_coco_dataset.py:117-129)."""
    x, y, w, h = bbox
    x1 = max(0.0, float(x))
    y1 = max(0.0, float(y))
    x2 = min(width - 1.0, x1 + max(0.0, float(w) - 1.0))
    y2 = min(height - 1.0, y1 + max(0.0, float(h) - 1.0))
    if x2 >= x1 and y2 >= y1:
        return [x1, y1, x2 - x1, y2 - y1]
    return None


def joints_from_ann(ann: dict, clean_bbox, num_keypoints: int):
    """Per-keypoint in-bbox visibility (reference:
    dataset/sbp_coco_dataset.py:143-155): a keypoint counts as labeled only
    if strictly inside the int-cast bbox; COCO visibility 2 collapses
    to 1."""
    x1 = int(clean_bbox[0])
    y1 = int(clean_bbox[1])
    x2 = x1 + int(clean_bbox[2])
    y2 = y1 + int(clean_bbox[3])
    joints = np.zeros((num_keypoints, 2), np.float64)
    joints_vis = np.zeros((num_keypoints,), np.float64)
    kp = ann["keypoints"]
    for ipt in range(num_keypoints):
        kx, ky, kv = kp[ipt * 3], kp[ipt * 3 + 1], kp[ipt * 3 + 2]
        if x1 < kx < x2 and y1 < ky < y2:
            joints[ipt, 0] = kx
            joints[ipt, 1] = ky
            joints_vis[ipt] = min(float(kv), 1.0)
    return joints, joints_vis


def load_sbp_instance_db(coco: CocoAnnotations, img_dir: Optional[str],
                         num_keypoints: int,
                         absolute_paths: bool = False) -> List[dict]:
    """One record per valid person instance (the reference's gt_db,
    dataset/sbp_coco_dataset.py:90-169).  With ``absolute_paths`` the
    annotation's ``file_name`` is the image path as it stands and
    ``img_dir`` is not joined (the PIS layout,
    dataset/sbp_pis_dataset.py:156)."""
    person_cats = {cid for cid, c in coco.cats.items()
                   if c.get("name") == "person"}
    db = []
    for img_id in coco.get_img_ids():
        im = coco.imgs[img_id]
        for ann_id in coco.get_ann_ids(img_id):
            ann = coco.anns[ann_id]
            if ann.get("iscrowd", 0):
                continue
            if ann["category_id"] not in person_cats:
                continue
            if not ann.get("keypoints") or max(ann["keypoints"]) == 0:
                continue
            clean = sanitize_bbox(ann["bbox"], im["width"], im["height"])
            if clean is None or ann.get("area", 0) <= 0:
                continue
            joints, joints_vis = joints_from_ann(ann, clean, num_keypoints)
            if joints_vis.sum() == 0:
                continue
            file_name = im["file_name"]
            db.append({
                "image_path": file_name if absolute_paths
                else os.path.join(img_dir, file_name),
                "bbox": np.asarray(clean, np.float64),
                "joints": joints,
                "joints_vis": joints_vis,
                "image_id": img_id,
                "category_id": ann["category_id"],
            })
    return db


def apply_clahe(img_rgb: np.ndarray, rng: np.random.RandomState,
                clip_range=(1.0, 4.0), tiles=(8, 8)) -> np.ndarray:
    """Albumentations-CLAHE semantics: clip limit drawn uniformly, applied
    to the L channel in LAB space (reference train transform CLAHE,
    dataset/sbp_coco_dataset.py:222)."""
    import cv2

    clip = float(rng.uniform(*clip_range))
    lab = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2LAB)
    lab[:, :, 0] = cv2.createCLAHE(
        clipLimit=clip, tileGridSize=tiles).apply(lab[:, :, 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(
        ((seed + 1) * 2654435761 + epoch * 1000003 + index) % (2 ** 32))


class _ImageLoaders:
    """The train and val loaders of an image data module (SBP, PIS, SPM),
    cv2 per sample or native per batch (``use_native``), with the optional
    host CLAHE on train images and the opt-in ``cache_images``.  A subclass
    gives ``_load(rec)`` (cv2), ``_box(rec)`` (the native crop box),
    ``_native_hw()``, ``_metadata(rec)`` and ``_image_cache``."""

    @property
    def use_native(self) -> bool:
        """None = the native loader when it is available, True = the native
        loader (raises with its build error when it is not), False = cv2.
        Resolved where it is read (the first loader), so that building a
        data module compiles nothing."""
        return native_loader.resolve_use_native(self._use_native)

    @use_native.setter
    def use_native(self, value: Optional[bool]) -> None:
        self._use_native = value

    def _finish(self, rec: dict, image: np.ndarray, index: int, epoch: int,
                train: bool) -> dict:
        """Host CLAHE (train, p = ``clahe_prob``) and the metadata."""
        if train and self.clahe_prob > 0:
            rng = _sample_rng(self.seed, epoch, index)
            if rng.uniform() < self.clahe_prob:
                image = apply_clahe(image, rng)
        out = self._metadata(rec)
        out["image"] = image
        return out

    def _sample_fn(self, train: bool, cache: Optional[dict]):
        def fn(rec, index, epoch):
            image = cache.get(index) if cache is not None else None
            if image is None:
                image = self._load(rec)
                if cache is not None:
                    cache[index] = image
            return self._finish(rec, image, index, epoch, train)
        return fn

    def _batch_fn(self, train: bool, cache: Optional[dict]):
        """Native-loader batch path: one call decodes, crops and resizes
        the batch's images that are not in the image cache on the C++
        thread pool."""
        out_h, out_w = self._native_hw()

        def fn(records, indices, epoch):
            images = [None] * len(records)
            miss, blobs, boxes = [], [], []
            for i, (rec, index) in enumerate(zip(records, indices)):
                if cache is not None:
                    hit = cache.get(int(index))
                    if hit is not None:
                        images[i] = hit
                        continue
                miss.append(i)
                with open(rec["image_path"], "rb") as f:
                    blobs.append(f.read())
                boxes.append(self._box(rec))
            if blobs:
                decoded = native_loader.batch_decode_crop_resize(
                    blobs, boxes, out_h, out_w,
                    n_threads=max(self.workers, 1))
                for pos, img in zip(miss, decoded):
                    images[pos] = img
                    if cache is not None:
                        cache[int(indices[pos])] = img
            return collate([
                self._finish(rec, image, int(index), epoch, train)
                for rec, index, image in zip(records, indices, images)])
        return fn

    def _loader(self, db, train: bool, batch_size=None,
                cache: Optional[dict] = None) -> HostLoader:
        """``train`` semantics: shuffle, drop_last, host CLAHE and this
        process's shard (``process_index`` of ``process_count``, set by the
        ``Trainer`` on several nodes; the val loader is not sharded: the
        sharded validation splits each global val batch into rows).
        ``cache`` is ``db``'s image cache (keyed by position in ``db``) or
        None; ``build_device_cache`` decodes ``train_db`` with val
        semantics and no cache, so the val cache never holds train
        crops."""
        shard = (self.process_index, self.process_count) if train else (0, 1)
        kwargs = dict(batch_size=batch_size or self.batch_size,
                      shuffle=train, seed=self.seed, drop_last=train,
                      workers=self.workers, process_index=shard[0],
                      process_count=shard[1])
        if self.use_native:
            return HostLoader(db, None, batch_fn=self._batch_fn(train, cache),
                              **kwargs)
        return HostLoader(db, self._sample_fn(train, cache), **kwargs)

    def _cache(self, train: bool) -> Optional[dict]:
        return self._image_cache[train] if self.cache_images else None

    def train_loader(self, batch_size=None) -> HostLoader:
        return self._loader(self.train_db, True, batch_size, self._cache(True))

    def val_loader(self, batch_size=None) -> HostLoader:
        return self._loader(self.val_db, False, batch_size,
                            self._cache(False))


class SBPCOCODataModule(_ImageLoaders):
    """Builds the train and val instance DBs and their host loaders (the
    reference datamodule surface, dataset/sbp_coco_dataset.py:190-277), with
    the JAX package's constructor arguments (``use_native``: see
    ``_ImageLoaders.use_native``).  A subclass that
    sets ``absolute_paths`` reads annotations whose ``file_name`` is
    already the image path (``SBPPISDataModule``)."""

    absolute_paths = False

    def __init__(self, train_path: Optional[str], val_path: Optional[str],
                 input_size, output_size, num_keypoints: int, sigma: float,
                 workers: int, batch_size: int,
                 class_labels: Sequence[str], img_dir: Optional[str] = None,
                 use_native: Optional[bool] = None, clahe_prob: float = 0.5,
                 seed: int = 0, cache_images: bool = False):
        self.train_path = train_path
        self.val_path = val_path
        self.img_dir = img_dir
        self.input_size = [int(s) for s in input_size]
        self.output_size = [int(s) for s in output_size]
        self.num_keypoints = int(num_keypoints)
        self.sigma = sigma
        self.workers = int(workers)
        self.batch_size = int(batch_size)
        self.class_labels = list(class_labels)
        self.use_native = use_native
        # host CLAHE probability on train crops; the Trainer zeroes it when
        # CLAHE runs on the device or is off
        self.clahe_prob = float(clahe_prob)
        self.seed = int(seed)
        # opt-in host RAM cache of the cropped and resized uint8 arrays
        # (deterministic per record: no random op precedes them)
        self.cache_images = bool(cache_images)
        self._image_cache = {True: {}, False: {}}
        # this process's train shard (the Trainer sets them on several
        # nodes)
        self.process_index = 0
        self.process_count = 1
        self.train_db: List[dict] = []
        self.val_db: List[dict] = []

    def setup(self):
        for attr, path in (("train_db", self.train_path),
                           ("val_db", self.val_path)):
            if path and os.path.exists(path):
                setattr(self, attr, load_sbp_instance_db(
                    CocoAnnotations(path),
                    None if self.absolute_paths
                    else coco_img_dir(self.img_dir, path),
                    self.num_keypoints, absolute_paths=self.absolute_paths))

    def _metadata(self, rec: dict) -> dict:
        """Joint coords crop frame -> resized-input frame (the reference's
        joint translation + Resize keypoint scaling,
        dataset/sbp_coco_dataset.py:53-72); invisible joints pinned at 0."""
        in_h, in_w = self.input_size
        bbox = rec["bbox"]
        ix1, iy1 = int(bbox[0]), int(bbox[1])
        crop_w = int(bbox[2]) + 1
        crop_h = int(bbox[3]) + 1
        joints = rec["joints"].astype(np.float32).copy()
        vis = rec["joints_vis"].astype(np.float32)
        visible = vis > 0
        joints[visible] -= np.asarray([ix1, iy1], np.float32)
        joints[visible] *= np.asarray([in_w / crop_w, in_h / crop_h],
                                      np.float32)
        joints[~visible] = 0.0
        return {
            "joints": joints,
            "joints_vis": vis,
            "bbox": rec["bbox"].astype(np.float64),
            "image_id": np.int64(rec["image_id"]),
            "category_id": np.int64(rec["category_id"]),
        }

    def _load(self, rec: dict) -> np.ndarray:
        import cv2

        in_h, in_w = self.input_size
        img = cv2.cvtColor(cv2.imread(rec["image_path"]), cv2.COLOR_BGR2RGB)
        bbox = rec["bbox"]
        ix1, iy1 = int(bbox[0]), int(bbox[1])
        ix2 = ix1 + int(bbox[2])
        iy2 = iy1 + int(bbox[3])
        crop = img[iy1:iy2 + 1, ix1:ix2 + 1]
        return cv2.resize(crop, (in_w, in_h),
                          interpolation=cv2.INTER_LINEAR)

    def _box(self, rec: dict) -> Tuple[int, int, int, int]:
        b = rec["bbox"]
        return int(b[0]), int(b[1]), int(b[2]), int(b[3])

    def _native_hw(self) -> Tuple[int, int]:
        return self.input_size[0], self.input_size[1]
