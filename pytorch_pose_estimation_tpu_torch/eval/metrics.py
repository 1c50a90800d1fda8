"""COCO keypoint mAP for SBP with the reference's accumulate/reset/result
surface (reference: utils/sbp_utils.py:121-189).

Counterpart of pytorch_pose_estimation_tpu/eval/metrics.py::SBPmAPCOCO.
The batch decodes in one call (kernel K2 on the card) and only the
results-list packing runs on the host.  Joints below the confidence
threshold become (0, 0, 0) with conf 0, visible joints get visibility flag
1, score = mean joint confidence, and coordinates map input crop -> bbox
frame -> original image.  The PIS and SPM metrics come with their slices.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.coco import CocoAnnotations
from ..ops.decode import decode_sbp_fast
from .cocoeval import KeypointEvaluator


class SBPmAPCOCO:
    """Top-down SBP keypoint AP@OKS=.50 on COCO-format annotations."""

    def __init__(self, json_path: str, input_size, conf_threshold: float):
        self.coco = CocoAnnotations(json_path)
        self.input_size = list(input_size)  # [height, width]
        self.conf_threshold = float(conf_threshold)
        self.result_list = []

    def reset_states(self):
        self.result_list = []

    def _pack(self, joints: np.ndarray, img_id: int, cat_id: int):
        tmp_joints, tmp_confs = [], []
        for (x, y, conf) in joints:
            if conf < 0:
                tmp_joints.extend([0, 0, 0])
                tmp_confs.append(0.0)
                continue
            tmp_joints.extend([float(x), float(y), 1])
            tmp_confs.append(float(conf))
        self.result_list.append({
            "image_id": int(img_id),
            "category_id": int(cat_id),
            "keypoints": tmp_joints,
            "score": float(sum(tmp_confs) / joints.shape[0]),
        })

    def update_state(self, target: dict, y_pred: torch.Tensor) -> None:
        """target: dict with 'bbox' [B,4], 'image_id' [B], 'category_id'
        [B]; y_pred: NCHW logits [B, K, H, W]."""
        joints = decode_sbp_fast(y_pred, int(self.input_size[1]),
                                 self.conf_threshold, True)
        self.update_state_decoded(target, joints)

    def update_state_decoded(self, target: dict, joints) -> None:
        """Same, with joints [B, K, 3] already decoded (input-size
        coordinates), as the eval step returns them."""
        if torch.is_tensor(joints):
            joints = joints.detach().cpu().numpy()
        joints = np.asarray(joints)
        bbox = np.asarray(target["bbox"], np.float64)
        img_ids = np.asarray(target["image_id"])
        cat_ids = np.asarray(target["category_id"])
        in_h, in_w = self.input_size
        for idx in range(joints.shape[0]):
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
        coco_dt = self.coco.load_results(self.result_list)
        evaluator = KeypointEvaluator(self.coco, coco_dt)
        stats = evaluator.run(verbose)
        return float(stats[1])
