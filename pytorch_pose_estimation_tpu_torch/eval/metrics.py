"""COCO keypoint mAP with the reference's accumulate/reset/result surface
(reference: utils/sbp_utils.py:121-189, utils/spm_utils.py:282-351,
utils/sbp_pis_utils.py:9-47).

Counterpart of pytorch_pose_estimation_tpu/eval/metrics.py (SBPmAPCOCO,
SBPmAPPIS, SPMmAPCOCO).
The batch decodes in one call (kernel K2 on the card) and only the
results-list packing runs on the host.  Joints below the confidence
threshold become (0, 0, 0) with conf 0, visible joints get visibility flag
1, score = mean joint confidence, and coordinates map input crop -> bbox
frame -> original image.  SPM: one result per decoded person, keypoints
scaled from the square input to the image; a (0, 0) keypoint is packed as
(0, 0, 0) with conf 0.  PIS: the 11 joints are packed as SBP's and 6
zero joints added, 51 numbers per result, scored by the 17-keypoint OKS
evaluator.  ``count`` limits an update to the first N rows of a padded
batch.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..data.coco import CocoAnnotations
from ..ops.decode import decode_sbp_fast, decode_spm_batch
from .cocoeval import KeypointEvaluator


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rows(n: int, count: Optional[int]) -> int:
    """The first ``count`` rows of ``n`` (all when None)."""
    return n if count is None else min(count, n)


def _evaluate(coco: CocoAnnotations, result_list: list, verbose: bool
              ) -> float:
    """OKS AP@.5 of ``result_list`` against ``coco``."""
    coco_dt = coco.load_results(result_list)
    return float(KeypointEvaluator(coco, coco_dt).run(verbose)[1])


class SBPmAPCOCO:
    """Top-down SBP keypoint AP@OKS=.50 on COCO-format annotations."""

    def __init__(self, json_path: str, input_size, conf_threshold: float):
        self.coco = CocoAnnotations(json_path)
        self.input_size = list(input_size)  # [height, width]
        self.conf_threshold = float(conf_threshold)
        self.result_list = []

    def reset_states(self):
        self.result_list = []

    _extra_zero_joints = 0

    def _pack(self, joints: np.ndarray, img_id: int, cat_id: int):
        tmp_joints, tmp_confs = [], []
        for (x, y, conf) in joints:
            if conf < 0:
                tmp_joints.extend([0, 0, 0])
                tmp_confs.append(0.0)
                continue
            tmp_joints.extend([float(x), float(y), 1])
            tmp_confs.append(float(conf))
        tmp_joints.extend([0] * (3 * self._extra_zero_joints))
        self.result_list.append({
            "image_id": int(img_id),
            "category_id": int(cat_id),
            "keypoints": tmp_joints,
            "score": float(sum(tmp_confs) / joints.shape[0]),
        })

    def update_state(self, target: dict, y_pred: torch.Tensor,
                     count: Optional[int] = None) -> None:
        """target: dict with 'bbox' [B,4], 'image_id' [B], 'category_id'
        [B]; y_pred: NCHW logits [B, K, H, W]."""
        joints = decode_sbp_fast(y_pred, int(self.input_size[1]),
                                 self.conf_threshold, True)
        self.update_state_decoded(target, joints, count)

    def update_state_decoded(self, target: dict, joints,
                             count: Optional[int] = None) -> None:
        """Same, with joints [B, K, 3] already decoded (input-size
        coordinates), as the eval step returns them."""
        joints = _numpy(joints)
        bbox = np.asarray(target["bbox"], np.float64)
        img_ids = np.asarray(target["image_id"])
        cat_ids = np.asarray(target["category_id"])
        in_h, in_w = self.input_size
        for idx in range(_rows(joints.shape[0], count)):
            j = joints[idx].astype(np.float64).copy()
            j[:, 0] = j[:, 0] * (bbox[idx][2] / in_w) + bbox[idx][0]
            j[:, 1] = j[:, 1] * (bbox[idx][3] / in_h) + bbox[idx][1]
            self._pack(j, img_ids[idx], cat_ids[idx])

    def result(self, verbose: bool = True) -> float:
        results_json_path = os.path.join(os.getcwd(), "results.json")
        with open(results_json_path, "w") as f:
            json.dump(self.result_list, f, indent=4)
        if not self.result_list:
            return 0.0
        return _evaluate(self.coco, self.result_list, verbose)


class SBPmAPPIS(SBPmAPCOCO):
    """11-keypoint PIS variant: 6 zero joints pad each result to the 17
    COCO slots of the OKS evaluator (reference:
    utils/sbp_pis_utils.py:40)."""

    _extra_zero_joints = 6


class SPMmAPCOCO:
    """Bottom-up SPM keypoint AP@OKS=.50: one result per decoded person,
    whole-image coordinate rescale."""

    def __init__(self, json_path: str, input_size: int, sigma: float,
                 conf_threshold: float, max_persons: int = 30):
        self.coco = CocoAnnotations(json_path)
        self.input_size = int(input_size)
        self.sigma = sigma
        self.conf_threshold = float(conf_threshold)
        self.max_persons = max_persons
        self.result_list = []

    def reset_states(self):
        self.result_list = []

    def update_state(self, target: dict, y_pred: torch.Tensor,
                     count: Optional[int] = None) -> None:
        """target: dict with 'image_size' [B,2] (w,h), 'image_id',
        'category_id'; y_pred: NCHW logits [B, 1+2K, S, S]."""
        decoded = decode_spm_batch(y_pred, self.input_size, self.sigma,
                                   self.conf_threshold, True,
                                   self.max_persons)
        self.update_state_decoded(target, decoded, count)

    def update_state_decoded(self, target: dict, decoded,
                             count: Optional[int] = None) -> None:
        """decoded: (roots [B,M,3], keypoints [B,M,K,3]) in input pixels,
        as the eval step returns them."""
        roots_b, kps_b = (_numpy(x) for x in decoded)
        image_sizes = np.asarray(target["image_size"], np.float64)
        img_ids = np.asarray(target["image_id"])
        cat_ids = np.asarray(target["category_id"])
        for idx in range(_rows(roots_b.shape[0], count)):
            keep = roots_b[idx, :, 2] >= 0
            kps = kps_b[idx][keep].astype(np.float64).copy()
            kps[..., 0] *= image_sizes[idx][0] / self.input_size
            kps[..., 1] *= image_sizes[idx][1] / self.input_size
            for person in kps:
                tmp_joints, tmp_confs = [], []
                for (px, py, conf) in person:
                    if px == 0.0 and py == 0.0:
                        tmp_joints.extend([0, 0, 0])
                        tmp_confs.append(0.0)
                        continue
                    tmp_joints.extend([float(px), float(py), 1])
                    tmp_confs.append(float(conf))
                self.result_list.append({
                    "image_id": int(img_ids[idx]),
                    "category_id": int(cat_ids[idx]),
                    "keypoints": tmp_joints,
                    "score": float(sum(tmp_confs) / person.shape[0]),
                })

    def result(self, verbose: bool = True) -> float:
        """AP@.5; results.json is written to the cwd only when there are
        results (the SBP metric writes it always)."""
        if not self.result_list:
            return 0.0
        with open(os.path.join(os.getcwd(), "results.json"), "w") as f:
            json.dump(self.result_list, f, indent=4)
        return _evaluate(self.coco, self.result_list, verbose)
