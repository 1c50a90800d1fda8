"""Metric-pipeline sanity check: feed the ground-truth annotations back
through the results + OKS evaluation path as if they were predictions and
print all 10 stats; the AP ceiling should be about 1.0.  Counterpart of the
repo's test_coco_keypoints_map.py (reference:
test_coco_keypoints_map.py:13-72).  Runs on the host only:

    python -m pytorch_pose_estimation_tpu_torch.test_coco_keypoints_map \\
        --cfg configs/sbp_coco.yaml
"""

import argparse

import numpy as np

from .config import get_configs
from .data import CocoAnnotations
from .eval import KeypointEvaluator


def main(cfg: dict) -> np.ndarray:
    """The 10 COCO keypoint stats of the ground truth of
    ``cfg['val_path']`` scored as results (score 0.9, visibility 1 for
    every labelled keypoint)."""
    coco = CocoAnnotations(cfg["val_path"])
    results = []
    for ann in coco.anns.values():
        kp = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
        out = []
        for (x, y, v) in kp:
            out.extend([float(x), float(y), 1 if v > 0 else 0])
        results.append({
            "image_id": ann["image_id"],
            "category_id": ann["category_id"],
            "keypoints": out,
            "score": 0.9,
        })
    evaluator = KeypointEvaluator(coco, coco.load_results(results))
    stats = evaluator.run(verbose=True)
    print(f"\nAP@OKS=.50 (stats[1]) = {stats[1]:.4f}")
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    args = parser.parse_args()
    main(get_configs(args.cfg))
