"""SBP serving and validation.

Counterpart of pytorch_pose_estimation_tpu/train/trainer.py:
``apply_precision_config``, ``build_model``, ``build_metric``,
``load_sbp_predictor`` and, for SBP, ``Trainer.validate``.  Training
(``Trainer.fit``, checkpoints, resume) comes with the training slice.

Entry points run on the card by default (``device="cuda"``) and raise when
CUDA is not available; they never carry on quietly on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..eval.metrics import SBPmAPCOCO
from ..models import SBP, lecun_normal_, load_state_dict_file
from ..ops.decode import decode_sbp_fast
from ..ops.image import normalize_batch
from .steps import make_sbp_eval_step

_EVAL_KEYS = ("image", "joints", "joints_vis")


def resolve_device(device) -> torch.device:
    """torch.device of ``device``; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return device


def apply_precision_config(cfg: dict) -> str:
    """'bf16' (default): bf16 conv compute, fp32 parameters, BN, loss,
    logits and decode.  'fp32': fp32 everywhere, with TF32 off in cuDNN
    convolutions and cuBLAS matmuls (cuDNN convolutions default to TF32)."""
    precision = cfg.get("precision", "bf16")
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be 'bf16' or 'fp32', got "
                         f"{precision!r}")
    if precision == "fp32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return precision


def build_model(cfg: dict) -> SBP:
    """SBP at the configured precision, initialized like the JAX package
    (lecun_normal) from a generator seeded with ``cfg['seed']`` (0)."""
    precision = apply_precision_config(cfg)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = SBP(num_keypoints=int(cfg["num_keypoints"]), dtype=dtype)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return lecun_normal_(model, gen)


def load_model(cfg: dict, ckpt: Optional[str], device="cuda") -> SBP:
    """``build_model``, weights from ``ckpt`` (a torch state_dict or
    Lightning checkpoint) when given, moved to ``device``, in eval mode."""
    device = resolve_device(device)
    model = build_model(cfg)
    if ckpt:
        model.load_state_dict(load_state_dict_file(ckpt))
    return model.to(device).eval()


def build_metric(cfg: dict) -> SBPmAPCOCO:
    return SBPmAPCOCO(cfg["val_path"], cfg["input_size"],
                      cfg["conf_threshold"])


def load_sbp_predictor(cfg: dict, ckpt: Optional[str], device="cuda"
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fused uint8-in / joints-out SBP predictor: normalize + forward +
    sigmoid decode (kernel K2 on the card).

    Returns ``predict(images_u8_nhwc) -> joints [B, K, 3]`` (a tensor on
    ``device``) in input-size pixel coordinates with the reference's
    sentinel scaling.  ``images`` may be a numpy array or a tensor.
    """
    device = resolve_device(device)
    model = load_model(cfg, ckpt, device)
    input_w = int(cfg["input_size"][1])
    conf = float(cfg["conf_threshold"])

    @torch.inference_mode()
    def predict(images) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        if images.dtype != torch.uint8 or images.dim() != 4 or \
                images.shape[-1] != 3:
            raise ValueError("images must be uint8 [B, H, W, 3], got "
                             f"{images.dtype} {tuple(images.shape)}")
        logits = model(normalize_batch(images))
        return decode_sbp_fast(logits, input_w, conf, True)

    return predict


def validate(cfg: dict, data_module, model: nn.Module, device="cuda",
             verbose: bool = True) -> Tuple[float, float]:
    """SBP validation (``Trainer.validate``): eval step over the data
    module's val loader, mean per-sample loss and OKS AP@.5 of the decoded
    joints.  Returns (val_loss, val_mAP)."""
    device = resolve_device(device)
    model = model.to(device).eval()
    eval_step = make_sbp_eval_step(
        model, cfg["input_size"], tuple(cfg["output_size"]),
        int(cfg["num_keypoints"]), float(cfg["sigma"]),
        float(cfg["conf_threshold"]))
    metric = build_metric(cfg)
    loss_sum, n_total = 0.0, 0
    for batch in data_module.val_loader():
        dev_batch = {k: torch.as_tensor(np.asarray(batch[k]), device=device)
                     for k in _EVAL_KEYS}
        per_sample, joints = eval_step(dev_batch)
        loss_sum += float(per_sample.sum())
        n_total += len(batch["image"])
        metric.update_state_decoded(batch, joints)
    val_loss = loss_sum / max(n_total, 1)
    val_map = metric.result(verbose=verbose)
    if verbose:
        print(f"val_loss={val_loss:.4f} val_mAP={val_map:.4f}")
    return val_loss, val_map
