"""chip_smoke.py phase 15's fit in the JAX package and in the port, on the
CPU: the same corpus (64 train and 16 val images of 5-8 persons, seeds 0
and 1), the same config (configs/spm_synth_hard.yaml's values: 256 -> 64,
batch 32, ``augment_geometric``, ``cache_images``; 2 epochs of 2 steps,
yolo_lr's burn-in cut to 1 step, a validation after each epoch), each
through its own ``train_spm.train``.  The two runs draw their own
initial weights and augmentation, so their losses agree in kind, not in
value.

It prints each epoch's train loss and val_loss of both packages and, as
its last line, one JSON object of them; it exits 1 unless the two
packages' losses move the same way (train loss and val_loss each falling
in both, or rising in both).  From the repo root (about 10 minutes and
8 GB on 8 cores):

    JAX_PLATFORMS=cpu python tests/spm_hard_witness.py
"""

import contextlib
import io
import json
import os
import re
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import train_spm as jax_train_spm  # noqa: E402


def _losses(text):
    """(train losses, val_losses) of the printed epoch lines."""
    return ([float(v) for v in re.findall(
                r"^epoch \d+: train_loss=(\S+)", text, re.M)],
            [float(v) for v in re.findall(
                r"^epoch \d+: val_loss=(\S+)", text, re.M)])


def main():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("jax", "port"):
            cfg, _ = chip_smoke.hard_config(tmp)
            cfg["save_dir"] = os.path.join(tmp, f"saved_{name}")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                if name == "jax":
                    jax_train_spm.train(cfg)
                else:
                    chip_smoke.train_spm.train(cfg, device="cpu")
            train, val = _losses(text.getvalue())
            out[name] = {"train_loss": train, "val_loss": val}
            print(f"{name}: train_loss {train}; val_loss {val}")
    ways = {name: tuple(v[-1] > v[0] for v in losses.values())
            for name, losses in out.items()}
    out["same_way"] = ways["jax"] == ways["port"]
    print(json.dumps(out))
    return 0 if out["same_way"] else 1


if __name__ == "__main__":
    sys.exit(main())
