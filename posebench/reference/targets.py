"""Ground-truth maps and losses in plain PyTorch, float32.

SBP (reference: utils/sbp_utils.py:33-53, models/loss/sbp_loss.py): per
visible joint a Gaussian of ``sigma`` stamped on the window
``round(c - 3s - 1) <= p < round(c + 3s + 2)`` around the joint's integer
cell; the loss is a masked sum of squared errors of the sigmoid, 5 on the
positive region and 1 elsewhere, over 2K, averaged over the batch.

SPM (reference: utils/spm_utils.py:16-95, models/loss/spm_loss.py): the
root heatmap (max over persons), each person's box mask around its root,
the displacement fields sum_p m (joint - grid) / sqrt(2 S^2) interleaved
(dx0, dy0, ...); the loss is the root's squared error plus 0.1 SmoothL1 of
the tanh fields, both masked by the true root map, averaged over the batch.
"""

from __future__ import annotations

import math

import torch


def _stamp(cx, cy, valid, h, w, sigma):
    """Gaussians around centers [...] where ``valid``: [..., h, w]."""
    cx, cy = cx[..., None, None], cy[..., None, None]
    ys = torch.arange(h, dtype=torch.float32, device=cx.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=cx.device)[None, :]
    ulx, uly = torch.round(cx - 3 * sigma - 1), torch.round(cy - 3 * sigma - 1)
    brx, bry = torch.round(cx + 3 * sigma + 2), torch.round(cy + 3 * sigma + 2)
    inside = (xs >= ulx) & (xs < brx) & (ys >= uly) & (ys < bry)
    gx, gy = xs - ulx - (3 * sigma + 1), ys - uly - (3 * sigma + 1)
    g = torch.exp(-(gx * gx + gy * gy) / (2.0 * sigma * sigma))
    return torch.where(inside & valid[..., None, None], g, 0.0)


def sbp_heatmaps(joints, vis, ratio, out_hw, sigma):
    """joints [B, K, 2] input px, vis [B, K] -> [B, K, h, w]."""
    h, w = int(out_hw[0]), int(out_hw[1])
    j = joints * ratio
    x, y = j[..., 0], j[..., 1]
    valid = (vis >= 1) & (x >= 0) & (y >= 0)
    cx = x.to(torch.int32).float().clamp(0, w - 1)
    cy = y.to(torch.int32).float().clamp(0, h - 1)
    return _stamp(cx, cy, valid, h, w, float(sigma))


def sbp_loss(logits, target):
    pred = torch.sigmoid(logits)
    pos = target > 0
    sq_pos = torch.where(pos, pred - target, 0.0).square().sum()
    sq_neg = torch.where(pos, 0.0, pred).square().sum()
    k = logits.shape[1]
    return (5.0 * sq_pos + sq_neg) / (2 * k) / logits.shape[0]


def _present(p):
    return ~((p[..., 0] <= 0) & (p[..., 1] <= 0))


def spm_target(centers, joints, ratio, size, sigma):
    """centers [B, P, 1, 2], joints [B, P, K, 2] input px -> [B, 1+2K, S,
    S]; the points are floored at the map's resolution."""
    c = torch.floor(centers * ratio)
    j = torch.floor(joints * ratio)
    s = int(size)
    hm = _stamp(c[..., 0], c[..., 1], _present(c), s, s,
                float(sigma)).amax(dim=-4)                     # [B, 1, S, S]
    half = int((6 * sigma + 2) / 2)
    grid = torch.arange(s, dtype=torch.float32, device=c.device)
    cx, cy = c[..., 0, None, None], c[..., 1, None, None]
    box = ((grid[None, :] >= cx - half) & (grid[None, :] < cx + half + 1)
           & (grid[:, None] >= cy - half) & (grid[:, None] < cy + half + 1))
    mask = (box & _present(c)[..., None, None]).any(dim=-3)   # [B, P, S, S]
    z = math.sqrt(2.0 * s * s)
    on = mask[:, :, None]                                     # [B, P, 1, S, S]
    present = _present(j)[..., None]                          # [B, P, K, 1]
    dx = torch.where(present, (j[..., 0, None] - grid) / z, 0.0)  # [B,P,K,S]
    dy = torch.where(present, (j[..., 1, None] - grid) / z, 0.0)
    fx = torch.where(on, dx[..., None, :], 0.0).sum(1)        # [B, K, S, S]
    fy = torch.where(on, dy[..., :, None], 0.0).sum(1)
    disp = torch.stack([fx, fy], 2).flatten(1, 2)
    return torch.cat([hm, disp], 1)


def spm_loss(logits, target):
    mask = (target[:, :1] > 0).float()
    root = torch.sigmoid(logits[:, :1]) * mask - target[:, :1]
    d = torch.tanh(logits[:, 1:]) * mask - target[:, 1:]
    ad = d.abs()
    smooth = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    return (root.square().sum() + 0.1 * smooth.sum()) / logits.shape[0]
