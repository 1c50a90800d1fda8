"""One arm of the angle-group A/B: the reference recipe
(configs/sbp_synth_ref.yaml: batch 256, sgd nesterov, yolo_lr) with the
rotation's angle shared by groups of B/G samples, trained on the ref-scale
synthetic corpus and validated, on the GPU by default.  Counterpart of the
repo's tools/ab_angle_groups.py, with the same argv and the same final
JSON line:

    python tests/synth_fixture.py ./data/ref_scale 5000 250 --hard
    python -m pytorch_pose_estimation_tpu_torch.tools.ab_angle_groups \\
        G [epochs=60] [--device cuda]

Run from the repo root (the config's paths are relative to it).
Checkpoints land under ``saved_ab/``; the G=16 arm's ``best`` is the
backbone-surgery source of the PIS run.  Like the training CLIs it trains
on every GPU that the config's ``devices`` selects (``parallel.run``).
"""

import argparse
import json
import time

from .. import parallel
from ..config import get_configs
from ..data import SBPCOCODataModule
from ..train import Trainer

CONFIG = "configs/sbp_synth_ref.yaml"


def make_cfg(G: int, epochs: int = 60, path: str = CONFIG) -> dict:
    """The arm's config: ``path`` updated key by key (a whole key is
    replaced, so ``trainer_options`` and ``augment_options`` hold only
    what is set here)."""
    cfg = get_configs(path)
    cfg.update({
        "dataset_name": f"ab-angles-g{G}",
        "epochs": epochs,
        "save_dir": "./saved_ab",
        "augment_options": {"angle_groups": G},
        "trainer_options": {"check_val_every_n_epoch": 10},
        "seed": 0,
    })
    return cfg


def run_arm(cfg: dict, G: int, device: str = "cuda") -> dict:
    """Fit and validate one arm; rank 0 prints the JSON line.  Returns
    it as a dict."""
    dm = SBPCOCODataModule(
        train_path=cfg["train_path"], val_path=cfg["val_path"],
        img_dir=cfg["img_dir"], input_size=cfg["input_size"],
        output_size=cfg["output_size"], num_keypoints=cfg["num_keypoints"],
        sigma=cfg["sigma"], workers=cfg["workers"],
        batch_size=cfg["batch_size"], class_labels=cfg["class_labels"])
    dm.setup()
    tr = Trainer(cfg, dm, kind="sbp", logging=True, device=device)
    t0 = time.time()
    tr.fit()
    val_loss, ap = tr.validate(verbose=False)
    result = {"G": G, "epochs": int(cfg["epochs"]),
              "val_loss": round(val_loss, 4), "ap50": round(float(ap), 4),
              "wall_s": round(time.time() - t0),
              "version_dir": tr.version_dir}
    if parallel.is_main():
        print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("G", type=int, help="angle groups per batch")
    parser.add_argument("epochs", type=int, nargs="?", default=60)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    cfg = make_cfg(args.G, args.epochs)
    return parallel.run(run_arm, cfg, args.device, cfg, args.G, args.device)


if __name__ == "__main__":
    main()
