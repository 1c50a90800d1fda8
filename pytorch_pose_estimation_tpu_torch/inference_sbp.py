"""Single-crop SBP inference with the ground truth beside the prediction,
and each image's latency (the reference's perf probe, reference:
inference_sbp.py:61-107); on the GPU by default.  Counterpart of the
repo's inference_sbp.py:

    python -m pytorch_pose_estimation_tpu_torch.inference_sbp \
        --cfg configs/sbp_coco.yaml --ckpt model.pt [--save-dir DIR] \
        [--limit N] [--device cuda]

The timed part is one call of the fused predictor (normalize, forward and
the decode, kernel K2 on the card).  The ground truth is stamped again and
decoded on the host with the plain versions, as the reference does.
Without ``--save-dir`` the images are shown with cv2.imshow (Esc stops).
"""

import argparse
import os
import time

import numpy as np

from .config import get_configs
from .data import SBPCOCODataModule
from .ops import DecodeSBP
from .ops.targets import SBPHeatmapGenerator
from .train import load_sbp_predictor, resolve_device
from .vis import get_coco_tagged_img_sbp


def inference(cfg: dict, ckpt, save_dir=None, limit=None,
              device: str = "cuda"):
    device = resolve_device(device)
    import cv2

    data_module = SBPCOCODataModule(
        train_path=None, val_path=cfg["val_path"], img_dir=cfg["img_dir"],
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"], sigma=cfg["sigma"],
        workers=cfg["workers"], batch_size=1,
        class_labels=cfg["class_labels"])
    data_module.setup()

    predict = load_sbp_predictor(cfg, ckpt, device)
    heatmap_gen = SBPHeatmapGenerator(cfg["output_size"],
                                      cfg["num_keypoints"], cfg["sigma"])
    true_decoder = DecodeSBP(cfg["input_size"], 0.99, pred=False)
    ratio = cfg["output_size"][0] / cfg["input_size"][0]
    in_h, in_w = cfg["input_size"]

    show = save_dir is None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    for i, batch in enumerate(data_module.val_loader()):
        if limit is not None and i >= limit:
            break
        bbox = batch["bbox"][0]
        org_img = cv2.imread(data_module.val_db[i]["image_path"])

        before = time.perf_counter()
        pred_joints = predict(batch["image"])[0].cpu().numpy()  # synced
        print(f"Inference: {(time.perf_counter() - before) * 1000:.2f}ms")

        # the ground truth decoded from re-stamped target heatmaps
        joints = batch["joints"][0] * ratio
        joints[batch["joints_vis"][0] < 1] = -1
        hms = heatmap_gen(joints)
        true_joints = np.asarray(true_decoder(hms[None])).copy()

        for j in (pred_joints, true_joints):
            j[..., 0] = j[..., 0] * (bbox[2] / in_w) + bbox[0]
            j[..., 1] = j[..., 1] * (bbox[3] / in_h) + bbox[1]

        pred_img = get_coco_tagged_img_sbp(org_img, pred_joints)
        true_img = get_coco_tagged_img_sbp(org_img, true_joints)

        if show:
            cv2.imshow("true", true_img)
            cv2.imshow("pred", pred_img)
            if cv2.waitKey(0) == 27:
                break
        else:
            cv2.imwrite(os.path.join(save_dir, f"{i:06d}_pred.jpg"), pred_img)
            cv2.imwrite(os.path.join(save_dir, f"{i:06d}_true.jpg"), true_img)
    if show:
        cv2.destroyAllWindows()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    parser.add_argument("--ckpt", required=True, type=str,
                        help="torch state_dict or checkpoint")
    parser.add_argument("--save-dir", type=str, default=None,
                        help="write tagged images here instead of imshow")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    inference(get_configs(args.cfg), args.ckpt, args.save_dir, args.limit,
              args.device)


if __name__ == "__main__":
    main()
