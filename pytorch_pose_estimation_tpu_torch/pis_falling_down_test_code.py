"""Falling-down accuracy harness: a confusion matrix over a PIS val set whose
image paths carry the class in a directory ('normal' = positive), and the
observed nose-shoulder gradient band, on the GPU by default.  Counterpart
of the repo's pis_falling_down_test_code.py (reference:
pis_falling_down_test_code.py:63-153):

    python -m pytorch_pose_estimation_tpu_torch.pis_falling_down_test_code \\
        --cfg configs/sbp_pis.yaml --ckpt CKPT [--label-depth -5] \\
        [--val-path JSON] [--device cuda]

``evaluate`` takes the predictor and the data module; ``run`` builds them
from the config.  The gradient is computed in float64 on the rescaled
joints, as in JAX.
"""

import argparse
import os

import numpy as np

from .config import get_configs
from .pis import NEG_MAX, POS_MIN
from .pis_handle_test_code import image_joints, numpy_joints, pis_val_data
from .train import load_sbp_predictor, resolve_device

NOSE, L_SHOULDER, R_SHOULDER = 0, 5, 6


def evaluate(predict, data_module, input_size, label_depth: int = -5):
    """(TP, TN, FP, FN) of the upright rule over
    ``data_module.val_loader()``; ``predict(images_u8) -> joints [B, K, 3]``
    in input pixels.  A sample with the nose or a shoulder missing counts
    against its own class."""
    tp = tn = fp = fn = 0
    normal_gradient, fall_gradient = [], []
    sample_idx = 0
    for batch in data_module.val_loader():
        joints = numpy_joints(predict(batch["image"]))
        for b in range(joints.shape[0]):
            rec = data_module.val_db[sample_idx]
            sample_idx += 1
            j = image_joints(joints[b], batch["bbox"][b], input_size)
            is_normal_gt = rec["image_path"].split(os.sep)[label_depth] == \
                "normal"
            nose, ls, rs = j[NOSE], j[L_SHOULDER], j[R_SHOULDER]
            if nose[-1] < 0 or ls[-1] < 0 or rs[-1] < 0:
                if is_normal_gt:
                    fn += 1
                else:
                    fp += 1
                continue
            center = (ls[:2] + rs[:2]) / 2
            gradient = (nose[1] - center[1]) / (nose[0] - center[0] + 1e-6)
            upright = gradient < NEG_MAX or POS_MIN < gradient
            if is_normal_gt:
                normal_gradient.append(gradient)
                tp += upright
                fn += not upright
            else:
                fall_gradient.append(gradient)
                fp += upright
                tn += not upright

    normal_gradient = np.asarray(normal_gradient)
    neg = normal_gradient[normal_gradient < 0]
    pos = normal_gradient[normal_gradient > 0]
    if neg.size and pos.size:
        print(f"neg_max: {neg.max()}, pos_min: {pos.min()}")
    total = tp + tn + fp + fn
    print(f"total: {total}, TP: {tp}, TN: {tn}, FP: {fp}, FN: {fn}")
    print(f"Accuracy: {((tp + tn) / max(total, 1) * 100):.2f}%")
    return tp, tn, fp, fn


def run(cfg: dict, ckpt, label_depth: int = -5, device: str = "cuda"):
    device = resolve_device(device)
    data_module = pis_val_data(cfg)
    predict = load_sbp_predictor(cfg, ckpt, device)
    return evaluate(predict, data_module, cfg["input_size"], label_depth)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    parser.add_argument("--ckpt", required=True, type=str,
                        help="torch state_dict or checkpoint")
    parser.add_argument("--label-depth", type=int, default=-5,
                        help="path component holding the class label")
    parser.add_argument("--val-path", type=str, default=None,
                        help="override cfg val_path (a labelled set)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    cfg = get_configs(args.cfg)
    if args.val_path:
        cfg["val_path"] = args.val_path
    return run(cfg, args.ckpt, args.label_depth, args.device)


if __name__ == "__main__":
    main()
