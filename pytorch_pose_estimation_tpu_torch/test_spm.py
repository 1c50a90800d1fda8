"""Evaluate an SPM checkpoint on the validation set (val_loss + COCO OKS
AP summary through the multi-person decode), on the GPU by default.
Counterpart of the repo's test_spm.py:

    python -m pytorch_pose_estimation_tpu_torch.test_spm \
        --cfg configs/spm_coco.yaml --ckpt model.pt [--device cuda]

``--ckpt`` is a torch state_dict, a Lightning checkpoint or a checkpoint
the port's ``Trainer`` wrote.
"""

import argparse

from .config import get_configs
from .data import SPMCOCODataModule
from .models import count_params
from .train import load_model, validate


def test(cfg: dict, ckpt: str, device: str = "cuda"):
    data_module = SPMCOCODataModule(
        train_path=None,
        val_path=cfg["val_path"],
        img_dir=cfg["img_dir"],
        input_size=cfg["input_size"],
        output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"],
        sigma=cfg["sigma"],
        workers=cfg["workers"],
        batch_size=cfg["batch_size"],
        class_labels=cfg.get("class_labels", ()),
        max_persons=cfg.get("max_persons", 30),
    )
    data_module.setup()
    model = load_model(cfg, ckpt, device, kind="spm")
    print(f"SPM: {count_params(model):,} parameters, "
          f"{len(data_module.val_db)} val images, device {device}")
    return validate(cfg, data_module, model, device, kind="spm")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    parser.add_argument("--ckpt", required=True, type=str,
                        help="torch state_dict or checkpoint")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    return test(get_configs(args.cfg), args.ckpt, args.device)


if __name__ == "__main__":
    main()
