"""Pure-Python COCO keypoint annotation index.

A copy of pytorch_pose_estimation_tpu/data/coco.py: the port imports
nothing of the JAX package, whose __init__ imports jax.

The reference delegates annotation indexing to pycocotools' ``COCO`` class
(reference: dataset/sbp_coco_dataset.py:28-34, utils/sbp_utils.py:8-9);
that C-extension package is not part of this framework, so the small slice
of its API the pipeline needs is implemented here: id-keyed ``imgs`` /
``anns`` / ``cats`` tables, an image -> annotation-ids index, and
``load_results`` with pycocotools ``loadRes`` semantics (detection ids
assigned sequentially, keypoint-extent bbox/area so area-range evaluation
works identically).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Union

import numpy as np

# Published per-keypoint OKS constants for the 17 COCO keypoints
# (pycocotools cocoeval.py setKpParams; consumed by eval/cocoeval.py).
COCO_KPT_SIGMAS = np.array(
    [.026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
     .107, .107, .087, .087, .089, .089], np.float64)


class CocoAnnotations:
    """COCO-format keypoint annotation database.

    Attributes mirror pycocotools: ``imgs`` (id -> image dict), ``anns``
    (id -> annotation dict), ``cats`` (id -> category dict).
    """

    def __init__(self, json_path: str = None):
        self.imgs: Dict[int, dict] = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self._img_to_anns: Dict[int, List[int]] = {}
        if json_path is not None:
            with open(json_path) as f:
                dataset = json.load(f)
            self._index(dataset)

    def _index(self, dataset: dict) -> None:
        for img in dataset.get("images", []):
            self.imgs[img["id"]] = img
            self._img_to_anns.setdefault(img["id"], [])
        for cat in dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self._img_to_anns.setdefault(ann["image_id"], []).append(
                ann["id"])

    # ------------------------------------------------------------------
    def get_ann_ids(self, img_id: int) -> List[int]:
        return self._img_to_anns.get(img_id, [])

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return list(self.cats.keys())

    def load_anns(self, ids: Sequence[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    # ------------------------------------------------------------------
    def load_results(self, results: Union[str, Sequence[dict]]
                     ) -> "CocoAnnotations":
        """Build a detection database from a COCO results list (or a json
        file of one).  Follows pycocotools ``COCO.loadRes`` for keypoint
        results: each entry gets a sequential id, and bbox/area are derived
        from the keypoint x/y extent (so area-range filtering matches)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        dt = CocoAnnotations()
        dt.imgs = self.imgs
        dt.cats = self.cats
        dt._img_to_anns = {img_id: [] for img_id in self.imgs}
        for i, res in enumerate(results):
            ann = dict(res)
            kp = np.asarray(ann["keypoints"], np.float64)
            x, y = kp[0::3], kp[1::3]
            x0, x1 = float(np.min(x)), float(np.max(x))
            y0, y1 = float(np.min(y)), float(np.max(y))
            ann["area"] = (x1 - x0) * (y1 - y0)
            ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            ann["id"] = i + 1
            dt.anns[ann["id"]] = ann
            dt._img_to_anns.setdefault(ann["image_id"], []).append(ann["id"])
        return dt
