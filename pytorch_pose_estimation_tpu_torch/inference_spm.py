"""Whole-image SPM inference: decode root joints and keypoints, draw them,
print each image's latency; on the GPU by default.  Counterpart of the
repo's inference_spm.py:

    python -m pytorch_pose_estimation_tpu_torch.inference_spm \
        --cfg configs/spm_coco.yaml --ckpt model.pt [--save-dir DIR] \
        [--limit N] [--device cuda]

Without ``--save-dir`` the images are shown with cv2.imshow (Esc stops).
"""

import argparse
import os
import time

import torch

from .config import get_configs
from .data import SPMCOCODataModule
from .ops import DecodeSPM
from .train import load_for_inference, resolve_device
from .vis import get_tagged_img_spm


def inference(cfg: dict, ckpt, save_dir=None, limit=None,
              device: str = "cuda"):
    device = resolve_device(device)
    import cv2

    data_module = SPMCOCODataModule(
        train_path=None, val_path=cfg["val_path"], img_dir=cfg["img_dir"],
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"], sigma=cfg["sigma"],
        workers=cfg["workers"], batch_size=1,
        class_labels=cfg["class_labels"],
        max_persons=cfg.get("max_persons", 30))
    data_module.setup()

    _, forward = load_for_inference(cfg, ckpt, "spm", device)
    decoder = DecodeSPM(cfg["input_size"], cfg["sigma"],
                        cfg["conf_threshold"], pred=True,
                        max_persons=cfg.get("max_persons", 30))

    show = save_dir is None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    for i, batch in enumerate(data_module.val_loader()):
        if limit is not None and i >= limit:
            break
        before = time.perf_counter()
        roots, kps = decoder(forward(batch["image"]))  # numpy: synced
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"Inference: {(time.perf_counter() - before) * 1000:.2f}ms")

        vis_img = cv2.cvtColor(batch["image"][0], cv2.COLOR_RGB2BGR)
        tagged = get_tagged_img_spm(vis_img, roots[:, :2], kps[..., :2])

        if show:
            cv2.imshow("pred", tagged)
            if cv2.waitKey(0) == 27:
                break
        else:
            cv2.imwrite(os.path.join(save_dir, f"{i:06d}_pred.jpg"), tagged)
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
