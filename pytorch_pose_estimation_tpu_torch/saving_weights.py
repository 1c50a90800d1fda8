"""Weight surgery: save the backbone of a checkpoint alone, to warm-start
the PIS model (reference: saving_weights.py:22-42; the file is what
configs/sbp_pis.yaml's ``model_pretrained`` reads).  Counterpart of the
repo's saving_weights.py, which writes an orbax directory; this writes one
torch file (``train.checkpoint.extract_backbone``):

    python -m pytorch_pose_estimation_tpu_torch.saving_weights \\
        --ckpt CKPT [--out pretrained_weights]

``--ckpt`` is a training checkpoint, a bare state_dict or a Lightning
checkpoint of a pose model.
"""

import argparse

from .train.checkpoint import extract_backbone


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True, type=str,
                        help="source checkpoint (torch file)")
    parser.add_argument("--out", type=str, default="pretrained_weights",
                        help="output file")
    args = parser.parse_args(argv)
    out = extract_backbone(args.ckpt, args.out)
    print(f"saved backbone weights to {out}")
    return out


if __name__ == "__main__":
    main()
