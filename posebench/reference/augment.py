"""The train steps' augmentation in plain PyTorch, float32.

The samplers draw the same numbers from the same generators, in the same
order, as the port's (``sample_augment``, ``sample_photometric``): the
per-example uniforms from a generator on the batch's device, the color
jitter's op order from a CPU generator.  The cores follow the published
op order (reference: dataset/sbp_coco_dataset.py:220-237): Rotate (a
Paeth three-shear about the center, one angle per contiguous group of
samples, applied per sample) -> CLAHE on the luma -> ColorJitter (one op
order for the batch) -> RandomResizedCrop -> clip to [0, 1].  Every
resampling is linear interpolation between the two nearest pixels with
reflect-101 borders, by gathering them; no value is rounded below
float32.  SPM's is photometric: CLAHE, then the jitter.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

JITTER_ORDERS = tuple(itertools.permutations(range(4)))


def _uniform(gen, n, lo, hi):
    return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo


def angle_groups(batch: int, requested: int) -> int:
    """The largest divisor of ``batch`` not above ``requested``."""
    g = max(1, min(int(requested), int(batch)))
    while batch % g:
        g -= 1
    return g


@dataclass
class Photometric:
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: int
    jitter: Optional[torch.Tensor]
    clahe: Optional[torch.Tensor]
    clahe_clip: Optional[torch.Tensor]


@dataclass
class Geometric:
    angles: torch.Tensor      # [G] radians
    rotate: torch.Tensor      # [B] bool
    x0: torch.Tensor          # [B] crop box, input px
    y0: torch.Tensor
    cw: torch.Tensor
    ch: torch.Tensor


def sample_photometric(gen, host_gen, b: int, jitter: Sequence[float],
                       clahe_prob: float, jitter_prob: float) -> Photometric:
    clahe = clip = None
    if clahe_prob > 0:
        clahe = _uniform(gen, b, 0.0, 1.0) < clahe_prob
        clip = _uniform(gen, b, 1.0, 4.0)
    fb, fc, fs, fh = jitter
    factors = (_uniform(gen, b, 1 - fb, 1 + fb),
               _uniform(gen, b, 1 - fc, 1 + fc),
               _uniform(gen, b, 1 - fs, 1 + fs), _uniform(gen, b, -fh, fh))
    apply = (_uniform(gen, b, 0.0, 1.0) < jitter_prob
             if jitter_prob < 1.0 else None)
    order = int(torch.randint(len(JITTER_ORDERS), (1,), generator=host_gen))
    return Photometric(*factors, order, apply, clahe, clip)


def sample_geometric(gen, host_gen, b: int, hw: Sequence[int], opts: dict):
    """(Geometric, Photometric) of one SBP batch, drawn in the port's
    order: angles, rotate flags, the photometric draws, the crops."""
    h, w = int(hw[0]), int(hw[1])
    g = angle_groups(b, opts["angle_groups"])
    limit = opts["rotate_limit"]
    angles = _uniform(gen, g, -limit, limit) * math.pi / 180.0
    if opts["rotate_prob"] >= 1.0:
        rotate = torch.ones(b, dtype=torch.bool, device=gen.device)
    else:
        rotate = _uniform(gen, b, 0.0, 1.0) < opts["rotate_prob"]
    photo = sample_photometric(gen, host_gen, b, opts["color_jitter"],
                               opts["clahe_prob"], opts["jitter_prob"])
    s0, s1 = opts["scale_range"]
    r0, r1 = opts["ratio_range"]
    area = h * w * _uniform(gen, b, s0, s1)
    aspect = torch.exp(_uniform(gen, b, math.log(r0), math.log(r1)))
    cw = torch.clamp(torch.sqrt(area * aspect), 8.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 8.0, h)
    x0 = _uniform(gen, b, 0.0, 1.0) * (w - cw)
    y0 = _uniform(gen, b, 0.0, 1.0) * (h - ch)
    return Geometric(angles, rotate, x0, y0, cw, ch), photo


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

def _fold(c: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 into [0, n - 1]."""
    if n == 1:
        return torch.zeros_like(c)
    period = 2.0 * (n - 1)
    c = torch.remainder(c, period)
    return torch.where(c > n - 1, period - c, c)


def _interp(img: torch.Tensor, src: torch.Tensor, dim: int) -> torch.Tensor:
    """img [B, C, H, W] read along ``dim`` (2 or 3) at coordinates ``src``
    ([B, H', W'] of the output's shape with C dropped), linearly between
    the two nearest pixels."""
    n = img.shape[dim]
    c = _fold(src, n)
    lo = torch.floor(c)
    frac = (c - lo)[:, None]
    lo = lo.long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    shape = (img.shape[0], img.shape[1]) + tuple(src.shape[1:])
    a = torch.gather(img, dim, lo[:, None].expand(shape))
    b = torch.gather(img, dim, hi[:, None].expand(shape))
    return a * (1 - frac) + b * frac


def _grid(h: int, w: int, device):
    return (torch.arange(h, dtype=torch.float32, device=device)[:, None]
            .expand(h, w),
            torch.arange(w, dtype=torch.float32, device=device)[None, :]
            .expand(h, w))


def rotate(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each [C, H, W] of img by its ``angle`` ([B], radians) about
    (W/2, H/2): x-shear by -tan(a/2), y-shear by sin(a), x-shear again;
    out[y, x] = in[y, x - s (y - cy)] for an x-shear."""
    b, _, h, w = img.shape
    cy, cx = h / 2.0, w / 2.0
    ys, xs = _grid(h, w, img.device)
    alpha = -torch.tan(angle / 2.0)[:, None, None]
    beta = torch.sin(angle)[:, None, None]

    def shear_x(x):
        return _interp(x, xs - alpha * (ys - cy), 3)

    def shear_y(x):
        return _interp(x, ys - beta * (xs - cx), 2)

    return shear_x(shear_y(shear_x(img)))


def crop_resize(img, x0, y0, cw, ch) -> torch.Tensor:
    """Each example's box resized to the full frame, half-pixel centers."""
    b, _, h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    src_y = y0[:, None] + (ys + 0.5) * (ch[:, None] / h) - 0.5    # [B, H]
    src_x = x0[:, None] + (xs + 0.5) * (cw[:, None] / w) - 0.5    # [B, W]
    out = _interp(img, src_y[:, :, None].expand(b, h, w), 2)
    return _interp(out, src_x[:, None, :].expand(b, h, w), 3)


def rotation_matrix(cx: float, cy: float, angle: torch.Tensor):
    """Forward rotations about (cx, cy): [B, 2, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s, cx - c * cx + s * cy], -1),
                        torch.stack([s, c, cy - s * cx - c * cy], -1)], -2)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def clahe(img: torch.Tensor, clip_limit: torch.Tensor, tiles: int = 8
          ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of the luma, per
    example: per tile a 256-bin histogram clipped at clip * area / 256
    (at least 1) with the excess spread evenly, its rounded CDF as the
    tile's map, each pixel's luma mapped bilinearly between the four
    nearest tile centers, the RGB pixel scaled by new / old luma."""
    b, _, h, w = img.shape
    th, tw = h // tiles, w // tiles
    area, bins, dev = th * tw, 256, img.device
    r, g, bl = img.unbind(1)
    y = 0.299 * r + 0.587 * g + 0.114 * bl
    y8 = torch.clamp(torch.round(y * 255.0), 0, 255).long()
    tile = ((torch.arange(h, device=dev) // th)[:, None] * tiles
            + (torch.arange(w, device=dev) // tw)[None, :])
    idx = ((torch.arange(b, device=dev)[:, None, None] * tiles * tiles
            + tile) * bins + y8).reshape(-1)
    hist = torch.zeros(b * tiles * tiles * bins, device=dev)
    hist.index_add_(0, idx, torch.ones(idx.numel(), device=dev))
    hist = hist.view(b, tiles * tiles, bins)
    limit = torch.clamp_min(clip_limit * area / bins, 1.0)[:, None, None]
    clipped = torch.minimum(hist, limit)
    clipped = clipped + (hist - clipped).sum(-1, keepdim=True) / bins
    lut = torch.round(torch.cumsum(clipped, -1) * ((bins - 1.0) / area))
    lut = lut.reshape(b, -1)
    fy = torch.clamp(torch.arange(h, device=dev) / th - 0.5, 0.0,
                     tiles - 1.0)[:, None]
    fx = torch.clamp(torch.arange(w, device=dev) / tw - 0.5, 0.0,
                     tiles - 1.0)[None, :]
    ty0, tx0 = torch.floor(fy).long(), torch.floor(fx).long()
    wy, wx = fy - ty0, fx - tx0
    ty1 = torch.clamp_max(ty0 + 1, tiles - 1)
    tx1 = torch.clamp_max(tx0 + 1, tiles - 1)

    def at(ty, tx):
        return torch.gather(lut, 1, ((ty * tiles + tx) * bins + y8)
                            .reshape(b, -1)).view(b, h, w)

    v = (at(ty0, tx0) * (1 - wy) * (1 - wx) + at(ty0, tx1) * (1 - wy) * wx
         + at(ty1, tx0) * wy * (1 - wx) + at(ty1, tx1) * wy * wx) / 255.0
    out = torch.clamp(img * (v / torch.clamp_min(y, 1e-6))[:, None], 0, 1)
    return torch.where(y[:, None] > 1e-6, out, img)


def _gray(x):
    return (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    d = maxc - minc
    s = torch.where(maxc > 0, d / torch.clamp_min(maxc, 1e-8), 0.0)
    dd = torch.clamp_min(d, 1e-8)
    rc, gc, bc = (maxc - r) / dd, (maxc - g) / dd, (maxc - b) / dd
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return h, s, maxc


def _pick(i, values):
    out = values[-1]
    for k in range(len(values) - 2, -1, -1):
        out = torch.where(i == k, values[k], out)
    return out


def _hsv_to_rgb(h, s, v):
    """The sector tables of the JAX package's hsv_to_rgb, which the port
    keeps: its g and b differ from colorsys's in some sectors."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.long() % 6
    return torch.stack([_pick(i, (v, q, p, p, t, v)),
                        _pick(i, (t, v, q, p, p, q)),
                        _pick(i, (p, p, t, v, q, v))], 1)


def color_jitter(img: torch.Tensor, d: Photometric) -> torch.Tensor:
    """Brightness, contrast, saturation and hue in the batch's op order,
    per-example factors, where ``d.jitter`` holds."""
    fb, fc, fs = (f[:, None, None, None]
                  for f in (d.brightness, d.contrast, d.saturation))
    fh = d.hue[:, None, None]

    def brightness(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def contrast(x):
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp((x - mean) * fc + mean, 0.0, 1.0)

    def saturation(x):
        g = _gray(x)
        return torch.clamp((x - g) * fs + g, 0.0, 1.0)

    def hue(x):
        h, s, v = _rgb_to_hsv(x)
        return torch.clamp(_hsv_to_rgb(torch.remainder(h + fh, 1.0), s, v),
                           0.0, 1.0)

    ops = (brightness, contrast, saturation, hue)
    out = img
    for i in JITTER_ORDERS[d.order]:
        out = ops[i](out)
    if d.jitter is not None:
        out = torch.where(d.jitter[:, None, None, None], out, img)
    return out


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 [B, 3, H, W] / 255."""
    return images_u8.permute(0, 3, 1, 2).float() / 255.0


def _rounded(img: torch.Tensor, quant) -> torch.Tensor:
    """The image where the program rounds it to its compute precision
    (the control rounds it to float8), else unchanged."""
    return img if quant is None else quant.operand(img)


def photometric(images_u8: torch.Tensor, d: Photometric, quant=None
                ) -> torch.Tensor:
    """SPM: /255 -> CLAHE where drawn -> jitter; no crop, no clip."""
    img = normalize(images_u8)
    if d.clahe is not None:
        img = torch.where(d.clahe[:, None, None, None],
                          clahe(img, d.clahe_clip), img)
    return color_jitter(_rounded(img, quant), d)


def geometric(images_u8, joints, vis, geo: Geometric, d: Photometric,
              quant=None):
    """SBP: images [B, H, W, 3] uint8, joints [B, K, 2] px, vis [B, K] ->
    (images [B, 3, H, W], joints, vis); joints ride each example's
    rotation and crop, and those that leave the frame become invisible.
    ``quant`` (the control) rounds the image before the rotation, the
    jitter and the crop, where the program rounds it to bf16."""
    img = _rounded(normalize(images_u8), quant)
    b, _, h, w = img.shape
    g = geo.angles.shape[0]
    per_sample = geo.angles.repeat_interleave(b // g)
    img = torch.where(geo.rotate[:, None, None, None],
                      rotate(img, per_sample), img)
    angle = torch.where(geo.rotate, per_sample, 0.0)
    m = rotation_matrix(w / 2.0, h / 2.0, angle)
    joints = joints @ m[:, :, :2].transpose(-1, -2) + m[:, None, :, 2]
    if d.clahe is not None:
        img = torch.where(d.clahe[:, None, None, None],
                          clahe(img, d.clahe_clip), img)
    img = _rounded(color_jitter(_rounded(img, quant), d), quant)
    img = torch.clamp(crop_resize(img, geo.x0, geo.y0, geo.cw, geo.ch),
                      0.0, 1.0)
    x = (joints[..., 0] - geo.x0[:, None]) * (w / geo.cw)[:, None]
    y = (joints[..., 1] - geo.y0[:, None]) * (h / geo.ch)[:, None]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return img, torch.stack([x, y], -1), vis * inside.float()
