"""Handle-grip accuracy harness: a confusion matrix over a PIS val set whose
image paths carry the class in a directory ('grip' = positive), on the GPU
by default.  Counterpart of the repo's pis_handle_test_code.py (reference:
pis_handle_test_code.py:69-128, the label at path component -5):

    python -m pytorch_pose_estimation_tpu_torch.pis_handle_test_code \\
        --cfg configs/sbp_pis.yaml --ckpt CKPT [--label-depth -5] \\
        [--val-path JSON] [--device cuda]

``evaluate`` takes the predictor and the data module, so a caller can feed
it batches from memory; ``run`` builds both from the config (the fused
predictor: normalize, forward and kernel K2 on the card, one call per
batch).  The joints are rescaled to the image in float64, as in JAX.
"""

import argparse
import os

import numpy as np
import torch

from .config import get_configs
from .data import SBPPISDataModule
from .pis import HANDLE_ROI, HandleGrip
from .train import load_sbp_predictor, resolve_device

RIGHT_WRIST = 10


def image_joints(joints: np.ndarray, bbox, input_size) -> np.ndarray:
    """joints [K, 3] in input pixels -> float64 image pixels through the
    instance's bbox."""
    in_h, in_w = input_size
    j = joints.astype(np.float64)
    j[:, 0] = j[:, 0] * (bbox[2] / in_w) + bbox[0]
    j[:, 1] = j[:, 1] * (bbox[3] / in_h) + bbox[1]
    return j


def numpy_joints(joints) -> np.ndarray:
    """The predictor's joints as numpy (a tensor anywhere, or an array)."""
    if torch.is_tensor(joints):
        return joints.detach().cpu().numpy()
    return np.asarray(joints)


def evaluate(predict, data_module, input_size, label_depth: int = -5):
    """(TP, TN, FP, FN) of the handle-grip rule on the right wrist over
    ``data_module.val_loader()``; ``predict(images_u8) -> joints [B, K, 3]``
    in input pixels.  A missing wrist counts as no grip."""
    handle_cls = HandleGrip(HANDLE_ROI)
    tp = tn = fp = fn = 0
    sample_idx = 0
    for batch in data_module.val_loader():
        joints = numpy_joints(predict(batch["image"]))
        for b in range(joints.shape[0]):
            rec = data_module.val_db[sample_idx]
            sample_idx += 1
            wrist = image_joints(joints[b], batch["bbox"][b],
                                 input_size)[RIGHT_WRIST]
            is_grip_gt = rec["image_path"].split(os.sep)[label_depth] == \
                "grip"
            if wrist[-1] < 0:
                grip_pred = False
            else:
                grip_pred = handle_cls.get_handle_grip_result(wrist[:2])
            if is_grip_gt:
                tp += grip_pred
                fn += not grip_pred
            else:
                tn += not grip_pred
                fp += grip_pred
    total = tp + tn + fp + fn
    print(f"total: {total}, TP: {tp}, TN: {tn}, FP: {fp}, FN: {fn}")
    print(f"Accuracy: {((tp + tn) / max(total, 1) * 100):.2f}%")
    return tp, tn, fp, fn


def pis_val_data(cfg: dict) -> SBPPISDataModule:
    """The config's PIS val set at its batch size."""
    data_module = SBPPISDataModule(
        train_path=None, val_path=cfg["val_path"],
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"], sigma=cfg["sigma"],
        workers=cfg["workers"], batch_size=cfg["batch_size"],
        class_labels=cfg["class_labels"])
    data_module.setup()
    return data_module


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
