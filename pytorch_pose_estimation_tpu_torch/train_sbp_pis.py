"""Train the PIS (11-keypoint upper-body) SBP model, on the GPU by default,
usually warm-started from a COCO model's backbone through the config's
``model_pretrained`` (see ``saving_weights``).  Counterpart of the repo's
train_sbp_pis.py (reference: train_sbp_pis.py):

    python -m pytorch_pose_estimation_tpu_torch.train_sbp_pis \\
        --cfg configs/sbp_pis.yaml [--resume CKPT|auto] [--device cuda]

With ``--device cuda`` it trains on every GPU that the config's
``devices`` selects ('auto': all), one process each (``parallel.run``),
or on the ranks of ``torchrun --nproc_per_node N -m
pytorch_pose_estimation_tpu_torch.train_sbp_pis --cfg ...``.
"""

import argparse

from . import parallel
from .config import get_configs
from .data import SBPPISDataModule
from .train import Trainer, resolve_device


def train(cfg: dict, resume=None, device: str = "cuda"):
    resolve_device(device)
    data_module = SBPPISDataModule(
        train_path=cfg["train_path"],
        val_path=cfg["val_path"],
        input_size=cfg["input_size"],
        output_size=cfg["output_size"],
        num_keypoints=cfg["num_keypoints"],
        sigma=cfg["sigma"],
        workers=cfg["workers"],
        batch_size=cfg["batch_size"],
        class_labels=cfg["class_labels"],
        cache_images=bool(cfg.get("cache_images", False)),
    )
    data_module.setup()

    trainer = Trainer(cfg, data_module, kind="pis", device=device)
    trainer.summary()
    return trainer.fit(resume=resume)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, type=str, help="config file")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume from, or 'auto'")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    cfg = get_configs(args.cfg)
    return parallel.run(train, cfg, args.device, cfg, args.resume,
                        args.device)


if __name__ == "__main__":
    main()
