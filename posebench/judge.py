"""The numbers that decide ``correct``, each held to a limit of the cell's
(``workloads/<cell>.json``, ``limits``; ``PERF.md`` gives the readings
each limit was set from).

Train cells, over the checked steps (the reference runs the same steps),
with each parameter's gap taken between the norms of the program's and
the reference's tensors, as a share of the reference's norm of that
parameter or of the median parameter's, whichever is larger, and the
parameters in the groups of the configuration's network (its
``groups``): the weights (``conv``: the trunk; ``deconv`` and ``head``:
the output layers), of which the output layers, and the normalizations'
scales and shifts (``bn``):

* ``loss_gap``: the relative gap of the first step's loss;
* ``logit_gap``: the first step's logits (this rank's rows), the norm of
  their difference over the norm of the reference's;
* ``grad_gap``: the median weight's gap of the first gradient;
* ``grad_gap_head``: the worst gap of the deconvolutions' and the head's
  weights;
* ``grad_gap_bn``: the median BN parameter's gap;
* ``update_gap``, ``update_gap_head``, ``update_gap_bn``: the same of the
  change over the checked steps, over the parameters whose reference
  gradient is at least a thousandth of the median's (the rest move by
  round-off alone).

The worst weight and the worst BN parameter (``*_worst``) and the later
steps' losses (``loss_gap_steps``) are reported beside them and not
compared: the gradients of the first layers' BN parameters and of the
convolutions that feed them are sums over every pixel of the batch that
nearly cancel, and bf16 rounding moves them by several hundredths and
more on every seed, the float8 control by about as much (PERF.md).

Serving cells, over a seeded sample of the requests answered in the
window, per joint:

* ``peak_gap``: how far the reference's logit at the cell the program
  reported lies below the reference's best logit of that map (a reported
  "not found" sentinel counts as the threshold's logit);
* ``conf_gap``: the largest gap between the reported confidence and the
  reference's sigmoid at the reported cell (for a reported "not found",
  how far the reference's best sigmoid lies above the threshold).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys
          ) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def leaf_gaps(prog: dict, ref: dict):
    """(each parameter's gap of the first gradient, each moved parameter's
    gap of the change)."""
    rg = ref["grad_norms"]
    med_g = statistics.median(rg.values())
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    return (_gaps(prog["grad_norms"], rg, list(rg)),
            _gaps(prog["change_norms"], ref["change_norms"], moved))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    steps = [abs(p - r) / max(abs(r), 1e-30)
             for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    grad, change = leaf_gaps(prog, ref)
    groups = ref["groups"]

    def of(gaps, *names):
        return [v for k, v in gaps.items() if groups[k] in names]

    weights, head = ("conv", "deconv", "head"), ("deconv", "head")
    lp = prog["logits"].double()
    lr = ref["logits"][:len(lp)].double()   # rank 0 holds the first rows
    return {"loss_gap": steps[0],
            "logit_gap": float((lp - lr).norm() / lr.norm()),
            "grad_gap": statistics.median(of(grad, *weights)),
            "grad_gap_head": max(of(grad, *head)),
            "grad_gap_bn": statistics.median(of(grad, "bn")),
            "update_gap": statistics.median(of(change, *weights)),
            "update_gap_head": max(of(change, *head)),
            "update_gap_bn": statistics.median(of(change, "bn")),
            "loss_gap_steps": max(steps),
            "grad_gap_worst": max(of(grad, *weights)),
            "grad_gap_bn_worst": max(of(grad, "bn")),
            "update_gap_worst": max(of(change, *weights))}


def infer_numbers(joints: np.ndarray, logits: np.ndarray, input_w: int,
                  threshold: float) -> Dict[str, float]:
    """joints [N, K, 3] (x, y, conf) as served, logits [N, K, h, w] of the
    reference for the same crops."""
    n, k, h, w = logits.shape
    scale = input_w / w
    flat = logits.reshape(n, k, h * w).astype(np.float64)
    best = flat.max(-1)
    found = joints[..., 2] >= 0
    col = np.rint(joints[..., 0] / scale).astype(np.int64)
    row = np.rint(joints[..., 1] / scale).astype(np.int64)
    on_grid = (np.abs(col * scale - joints[..., 0]) < 1e-3 * scale) & \
        (np.abs(row * scale - joints[..., 1]) < 1e-3 * scale) & \
        (col >= 0) & (col < w) & (row >= 0) & (row < h)
    idx = np.clip(row, 0, h - 1) * w + np.clip(col, 0, w - 1)
    at = np.take_along_axis(flat, idx[..., None], -1)[..., 0]
    floor = math.log(threshold / (1.0 - threshold))
    chosen = np.where(found, at, floor)
    peak = np.where(found & ~on_grid, np.inf, np.maximum(best - chosen, 0.0))
    sig = 1.0 / (1.0 + np.exp(-at))
    missed = np.maximum(1.0 / (1.0 + np.exp(-best)) - threshold, 0.0)
    conf = np.where(found, np.abs(joints[..., 2] - sig), missed)
    return {"peak_gap": float(peak.max()), "conf_gap": float(conf.max())}


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    return {name: {"value": float(numbers[name]),
                   "limit": float(limits[name])} for name in limits}
