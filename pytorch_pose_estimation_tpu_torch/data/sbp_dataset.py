"""SBP (top-down, one sample per person instance) COCO data layer, val path.

Counterpart of pytorch_pose_estimation_tpu/data/sbp_dataset.py with the
cv2 loader: the host decodes the JPEG, crops the clean GT bbox, resizes it
to the model input and ships uint8 pixels plus joint metadata.  cv2 is
imported where an image is read, so the package imports without it.  The
train loader (with host CLAHE) and the native C++ loader come with the
training slice.

Annotation sanitization follows the reference rule for rule (reference:
dataset/sbp_coco_dataset.py:97-169):
* bbox clipped into the image, kept only if area > 0 and non-degenerate;
* persons only, instances with no labeled keypoints dropped;
* a keypoint is visible only if strictly inside the int-cast clean bbox;
* instances whose keypoints are all invisible are dropped.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .coco import CocoAnnotations
from .pipeline import HostLoader


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


def load_sbp_instance_db(coco: CocoAnnotations, img_dir: str,
                         num_keypoints: int) -> List[dict]:
    """One record per valid person instance (the reference's gt_db,
    dataset/sbp_coco_dataset.py:90-169)."""
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
            db.append({
                "image_path": os.path.join(img_dir, im["file_name"]),
                "bbox": np.asarray(clean, np.float64),
                "joints": joints,
                "joints_vis": joints_vis,
                "image_id": img_id,
                "category_id": ann["category_id"],
            })
    return db


class SBPCOCODataModule:
    """Builds the val instance DB and its host loader (reference datamodule
    surface, dataset/sbp_coco_dataset.py:190-277, val side)."""

    def __init__(self, val_path: str, img_dir: str, input_size,
                 num_keypoints: int, workers: int, batch_size: int):
        self.val_path = val_path
        self.img_dir = img_dir
        self.input_size = [int(s) for s in input_size]
        self.num_keypoints = int(num_keypoints)
        self.workers = int(workers)
        self.batch_size = int(batch_size)
        self.val_db: List[dict] = []

    def setup(self):
        if self.val_path and os.path.exists(self.val_path):
            self.val_db = load_sbp_instance_db(
                CocoAnnotations(self.val_path),
                coco_img_dir(self.img_dir, self.val_path),
                self.num_keypoints)

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

    def _load_crop(self, rec: dict) -> np.ndarray:
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

    def _sample(self, rec: dict) -> dict:
        out = self._metadata(rec)
        out["image"] = self._load_crop(rec)
        return out

    def val_loader(self) -> HostLoader:
        return HostLoader(self.val_db, self._sample,
                          batch_size=self.batch_size,
                          workers=self.workers)
