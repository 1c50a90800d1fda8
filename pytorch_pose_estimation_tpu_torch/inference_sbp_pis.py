"""PIS inference with the behaviour rules drawn over each image, and each
image's latency, on the GPU by default.  Counterpart of the repo's
inference_sbp_pis.py (reference: inference_sbp_pis.py:17-173):

    python -m pytorch_pose_estimation_tpu_torch.inference_sbp_pis \\
        --cfg configs/sbp_pis.yaml --ckpt CKPT \\
        [--pis {handle_grip,falling_down}] [--save-dir DIR] [--limit N] \\
        [--device cuda]

The timed part is one call of the fused predictor (normalize, forward and
the decode, kernel K2 on the card).  The joints come back as numpy float32
and the rules compute on them in float32, as the JAX CLI's do.  Without
``--save-dir`` the images are shown with cv2.imshow (Esc stops).  cv2 is
imported when the command runs, not with the module.
"""

import argparse
import os
import time

from .config import get_configs
from .data import SBPPISDataModule
from .pis import HANDLE_ROI, NEG_MAX, POS_MIN, FallingDown, HandleGrip
from .train import load_sbp_predictor, resolve_device
from .vis import get_pis_tagged_img_sbp


def _overlay_text(img, txt, color):
    import cv2

    font = cv2.FONT_HERSHEY_SIMPLEX
    size, _ = cv2.getTextSize(txt, font, 2, 2)
    cv2.putText(img, txt, (10, 10 + size[1]), font, 2, color, 2)


def inference(cfg: dict, ckpt, pis=None, save_dir=None, limit=None,
              device: str = "cuda"):
    device = resolve_device(device)
    import cv2

    data_module = SBPPISDataModule(
        train_path=None, val_path=cfg["val_path"],
        input_size=cfg["input_size"], output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"], sigma=cfg["sigma"],
        workers=cfg["workers"], batch_size=1,
        class_labels=cfg["class_labels"])
    data_module.setup()

    predict = load_sbp_predictor(cfg, ckpt, device)
    in_h, in_w = cfg["input_size"]
    handle_cls = HandleGrip(HANDLE_ROI)
    falling_cls = FallingDown(NEG_MAX, POS_MIN)

    show = save_dir is None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    for i, batch in enumerate(data_module.val_loader(batch_size=1)):
        if limit is not None and i >= limit:
            break
        bbox = batch["bbox"][0]
        org_img = cv2.imread(data_module.val_db[i]["image_path"])

        before = time.perf_counter()
        joints = predict(batch["image"])[0].cpu().numpy()  # synced
        print(f"Inference: {(time.perf_counter() - before) * 1000:.2f}ms")

        joints[..., 0] = joints[..., 0] * (bbox[2] / in_w) + bbox[0]
        joints[..., 1] = joints[..., 1] * (bbox[3] / in_h) + bbox[1]

        if pis == "handle_grip":
            cv2.line(org_img, HANDLE_ROI[0], HANDLE_ROI[1], (255, 0, 0), 2)
            # right wrist = keypoint index 10
            grip = joints[10][-1] >= 0 and \
                handle_cls.get_handle_grip_result(joints[10][:2])
            _overlay_text(org_img, "Handle Grip" if grip else "No Grip",
                          (0, 200, 0) if grip else (0, 0, 255))
        elif pis == "falling_down":
            # nose = 0, shoulders = 5 and 6
            if joints[0][-1] >= 0 and joints[5][-1] >= 0 and \
                    joints[6][-1] >= 0:
                center = (joints[5][:2] + joints[6][:2]) / 2
                normal = falling_cls.get_falling_down_result(joints[0][:2],
                                                             center)
            else:
                normal = True
            _overlay_text(org_img, "Normal" if normal else "Falling Down",
                          (0, 200, 0) if normal else (0, 0, 255))

        tagged = get_pis_tagged_img_sbp(org_img, joints)
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
    parser.add_argument("--pis", type=str, default=None,
                        choices=["handle_grip", "falling_down"])
    parser.add_argument("--save-dir", type=str, default=None,
                        help="write tagged images here instead of imshow")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    inference(get_configs(args.cfg), args.ckpt, args.pis, args.save_dir,
              args.limit, args.device)


if __name__ == "__main__":
    main()
