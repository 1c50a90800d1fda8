"""SPM (bottom-up, one sample per image) COCO data layer.

Counterpart of pytorch_pose_estimation_tpu/data/spm_dataset.py with the
cv2 loader (reference: dataset/spm_coco_dataset.py:40-95, :120-192): the
host reads the whole image, resizes it to the square input and ships the
uint8 pixels with every person's joints and a root joint per person (the
center of the int-cast clean bbox), scaled to the input; the targets and
the augmentation run on the device.  Persons are padded to
``max_persons`` with (0, 0), the absent-point sentinel the SPM targets
skip.  The loaders are SBP's (``sbp_dataset._ImageLoaders``): cv2 per
sample or the native loader per batch, whole-image boxes
``(-1, -1, -1, -1)``, chosen by ``use_native`` as in the JAX package; the
optional host CLAHE on train images draws from the same per-record stream
as SBP's.  cv2 is imported where an image is read.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .coco import CocoAnnotations
from .sbp_dataset import (_ImageLoaders, coco_img_dir, joints_from_ann,
                          sanitize_bbox)


def load_spm_image_db(coco: CocoAnnotations, img_dir: str,
                      num_keypoints: int) -> List[dict]:
    """One record per image with at least one valid person; the
    sanitization rules are SBP's (``load_sbp_instance_db``)."""
    person_cats = {cid for cid, c in coco.cats.items()
                   if c.get("name") == "person"}
    db = []
    for img_id in coco.get_img_ids():
        im = coco.imgs[img_id]
        joints_list, vis_list, centers = [], [], []
        cat_id = None
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
            x1, y1 = int(clean[0]), int(clean[1])
            x2 = x1 + int(clean[2])
            y2 = y1 + int(clean[3])
            joints_list.append(joints)
            vis_list.append(joints_vis)
            centers.append([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
            cat_id = ann["category_id"]
        if joints_list:
            db.append({
                "image_path": os.path.join(img_dir, im["file_name"]),
                "joints": np.asarray(joints_list, np.float64),
                "joints_vis": np.asarray(vis_list, np.float64),
                "centers": np.asarray(centers, np.float64),
                "image_id": img_id,
                "category_id": cat_id,
                "image_size": (im["width"], im["height"]),
            })
    return db


class SPMCOCODataModule(_ImageLoaders):
    """Whole-image train and val loaders, with the JAX package's
    constructor arguments; ``use_native`` as in ``SBPCOCODataModule``."""

    def __init__(self, train_path: Optional[str], val_path: Optional[str],
                 img_dir: Optional[str], input_size: int, output_size: int,
                 num_keypoints: int, sigma: float, workers: int,
                 batch_size: int, class_labels: Sequence[str],
                 max_persons: int = 30, use_native: Optional[bool] = None,
                 clahe_prob: float = 0.5, seed: int = 0,
                 cache_images: bool = False):
        self.train_path = train_path
        self.val_path = val_path
        self.img_dir = img_dir
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        self.num_keypoints = int(num_keypoints)
        self.sigma = sigma
        self.workers = int(workers)
        self.batch_size = int(batch_size)
        self.class_labels = list(class_labels)
        self.max_persons = int(max_persons)
        self.use_native = use_native
        # host CLAHE probability on train images; the Trainer zeroes it when
        # CLAHE runs on the device or is off
        self.clahe_prob = float(clahe_prob)
        self.seed = int(seed)
        # opt-in host RAM cache of the resized uint8 images
        self.cache_images = bool(cache_images)
        self._image_cache = {True: {}, False: {}}
        # this process's train shard (the Trainer sets them on several
        # nodes)
        self.process_index = 0
        self.process_count = 1
        self.train_db: List[dict] = []
        self.val_db: List[dict] = []

    def prepare_data(self):
        pass

    def setup(self):
        for attr, path in (("train_db", self.train_path),
                           ("val_db", self.val_path)):
            if path and os.path.exists(path):
                setattr(self, attr, load_spm_image_db(
                    CocoAnnotations(path), coco_img_dir(self.img_dir, path),
                    self.num_keypoints))

    def _metadata(self, rec: dict) -> dict:
        """All persons' joints and centers, original px -> input px, the
        person axis padded with (0, 0) (reference keypoint chain:
        dataset/spm_coco_dataset.py:53-73)."""
        s = self.input_size
        w0, h0 = rec["image_size"]
        scale = np.asarray([s / w0, s / h0], np.float32)
        p = min(rec["joints"].shape[0], self.max_persons)
        joints = np.zeros((self.max_persons, self.num_keypoints, 2),
                          np.float32)
        centers = np.zeros((self.max_persons, 1, 2), np.float32)
        joints[:p] = rec["joints"][:p].astype(np.float32) * scale
        centers[:p, 0] = rec["centers"][:p].astype(np.float32) * scale
        return {
            "joints": joints,
            "centers": centers,
            "image_id": np.int64(rec["image_id"]),
            "category_id": np.int64(rec["category_id"]),
            "image_size": np.asarray(rec["image_size"], np.int64),
        }

    def _load(self, rec: dict) -> np.ndarray:
        import cv2

        s = self.input_size
        img = cv2.cvtColor(cv2.imread(rec["image_path"]), cv2.COLOR_BGR2RGB)
        return cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)

    def _box(self, rec: dict) -> Tuple[int, int, int, int]:
        return (-1, -1, -1, -1)  # the whole image

    def _native_hw(self) -> Tuple[int, int]:
        return self.input_size, self.input_size
