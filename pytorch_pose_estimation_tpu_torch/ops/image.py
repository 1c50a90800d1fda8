"""Image preprocessing and train-time augmentation on tensors, NCHW.

Counterpart of pytorch_pose_estimation_tpu/ops/image.py: ``normalize_batch``
(val) and ``augment_batch`` (train) with its parts, in the reference's op
order (reference: dataset/sbp_coco_dataset.py:220-237): Rotate(p=0.5) ->
[CLAHE(p), opt-in] -> ColorJitter(p=0.5) -> RandomResizedCrop(p=1) ->
clip to [0, 1].

Every random op is split in two.  A sampler (``sample_augment``) draws the
parameters from ``torch.Generator``s; a deterministic core takes them as
tensors (``AugmentDraws``).  Draws of the JAX package's threefry never equal
torch's, so the tests feed the same draws to both cores.  The per-example
draws come from a generator on the batch's device.  The one batch-wide
draw, the color jitter's op order, picks which ops run, so it comes from a
generator on the host: reading a device draw would stall the host on the
card every step.

The cores keep the JAX semantics:

* rotation is the Paeth three-shear (``rotate_shear3_grouped``), with one
  angle per contiguous group of samples and a per-sample apply mask;
* every resampling is a contraction with linear-interpolation weight rows
  (``_interp_weights``, reflect-101 borders); image and weights are rounded
  to bf16, the products are exact in fp32 and the sums are taken in fp32,
  as the JAX einsums with ``preferred_element_type=fp32`` do;
* color jitter: per-example factors cast to the image dtype, one
  batch-shared order out of the 24 permutations of (brightness, contrast,
  saturation, hue) in ``itertools.permutations`` order, a per-example
  apply mask, the contrast mean taken in fp32;
* CLAHE on the luma channel, per example, with 256-bin tile histograms.

The SPM train step's default augmentation is photometric only (CLAHE,
then color jitter: ``sample_photometric`` and ``spm_photometric_core``).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

# the color jitter's op orders, indexed by the batch's draw
JITTER_ORDERS = tuple(itertools.permutations(range(4)))


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """Val-time preprocessing, Normalize(0, 1) == /255 (reference:
    dataset/sbp_coco_dataset.py:234-237): uint8 [B, H, W, 3] ->
    contiguous fp32 [B, 3, H, W] on the same device.

    The divisor is a 0-dim tensor on the images' device: divided by a
    Python scalar, a CUDA tensor is multiplied by the scalar's reciprocal,
    1 ulp off the quotient for some pixel values, and CLAHE's luma bins
    turn that ulp into a whole bin."""
    x = images_u8.permute(0, 3, 1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)
    return x / torch.full((), 255.0, device=x.device)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def _rotation_about(cx: float, cy: float, angle: torch.Tensor
                    ) -> torch.Tensor:
    """Forward rotations by ``angle`` radians ([...]) about (cx, cy):
    [..., 2, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([
        torch.stack([c, -s, cx - c * cx + s * cy], -1),
        torch.stack([s, c, cy - s * cx - c * cy], -1)], -2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 2, 3] affines to [..., N, 2] (x, y) points."""
    return pts @ m[..., :2].transpose(-1, -2) + m[..., None, :, 2]


def _reflect101(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Fold coordinates into [0, size - 1], reflect-101 (no edge repeat)."""
    if size == 1:
        return torch.zeros_like(coord)
    period = 2.0 * (size - 1)
    c = torch.remainder(coord, period)
    return torch.where(c > size - 1, period - c, c)


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """img [C, H, W] sampled at coordinates ys, xs [h, w] (reflect-101
    borders): [C, h, w]."""
    h, w = img.shape[-2:]
    ys = _reflect101(ys, h)
    xs = _reflect101(xs, w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0 = y0.long().clamp(0, h - 1)
    x0 = x0.long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    top = img[:, y0, x0] * (1 - wx) + img[:, y0, x1] * wx
    bot = img[:, y1, x0] * (1 - wx) + img[:, y1, x1] * wx
    return top * (1 - wy) + bot * wy


def affine_warp(img: torch.Tensor, inv_matrix: torch.Tensor,
                out_hw: Sequence[int]) -> torch.Tensor:
    """Warp [C, H, W] by the inverse affine ``inv_matrix`` [2, 3] (output
    (x, y, 1) -> input (x, y)), bilinear with reflect-101 borders:
    [C, out_h, out_w]."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    m = inv_matrix.to(torch.float32)
    ys, xs = _axes(oh, ow, img.device)
    ys, xs = ys[:, None].expand(oh, ow), xs[None, :].expand(oh, ow)
    in_x = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    in_y = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return _bilinear_sample(img, in_y, in_x)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[2, 3] affines: result(x) = a(b(x))."""
    row = torch.tensor([[0.0, 0.0, 1.0]], dtype=a.dtype, device=a.device)
    return (torch.cat([a, row]) @ torch.cat([b, row]))[:2]


def _crop_resize(x0, y0, cw, ch, out_w: int, out_h: int) -> torch.Tensor:
    """The forward affine taking input px in the crop box to output px."""
    sx, sy = out_w / cw, out_h / ch
    zero = torch.zeros_like(sx)
    return torch.stack([torch.stack([sx, zero, -x0 * sx]),
                        torch.stack([zero, sy, -y0 * sy])])


def _invert(m: torch.Tensor) -> torch.Tensor:
    """The inverse of a [2, 3] affine."""
    a, b, c = m[0]
    d, e, f = m[1]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    return torch.stack([torch.stack([ia, ib, -(ia * c + ib * f)]),
                        torch.stack([id_, ie, -(id_ * c + ie * f)])])


@dataclass
class TrainAffineDraws:
    """The five uniforms of one ``sample_train_affine`` call, 0-dim fp32."""
    angle: torch.Tensor       # degrees, in +-rotate_limit
    scale: torch.Tensor       # crop area fraction, in scale_range
    log_ratio: torch.Tensor   # in log(ratio_range)
    x: torch.Tensor           # crop origin fractions, in [0, 1)
    y: torch.Tensor


def sample_train_affine(gen: torch.Generator, in_hw: Sequence[int],
                        rotate_limit: float = 40.0,
                        scale_range: Sequence[float] = (0.4, 1.0),
                        ratio_range: Sequence[float] = (0.4, 1.6)
                        ) -> TrainAffineDraws:
    """Draw one example's Rotate(+-rotate_limit) then RandomResizedCrop
    (scale, ratio) parameters from ``gen``; ``train_affine_core(draws,
    in_hw)`` makes the matrix.  ``in_hw`` keeps the JAX signature: the
    draws do not depend on it."""
    def draw(lo, hi):
        return _uniform(gen, 1, lo, hi)[0]

    return TrainAffineDraws(draw(-rotate_limit, rotate_limit),
                            draw(scale_range[0], scale_range[1]),
                            draw(math.log(ratio_range[0]),
                                 math.log(ratio_range[1])),
                            draw(0.0, 1.0), draw(0.0, 1.0))


def train_affine_core(draws: TrainAffineDraws, in_hw: Sequence[int]
                      ) -> torch.Tensor:
    """The forward [2, 3] affine (input px -> output px) of Rotate(angle
    about the center) then the crop of ``draws`` resized back to
    ``in_hw``, torchvision-style: area fraction and log aspect ratio."""
    h, w = int(in_hw[0]), int(in_hw[1])
    rot = _rotation_about(w / 2.0, h / 2.0, draws.angle * math.pi / 180.0)
    area = h * w * draws.scale
    aspect = torch.exp(draws.log_ratio)
    cw = torch.clamp(torch.sqrt(area * aspect), 8.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 8.0, h)
    crop = _crop_resize(draws.x * (w - cw), draws.y * (h - ch), cw, ch, w, h)
    return _compose(crop, rot)


def _interp_weights(src: torch.Tensor, n_in: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Linear-interpolation weight rows for sample coordinates ``src``
    ([...]) into an axis of length ``n_in``, reflect-101 folded: [..., n_in]
    with at most two non-zero taps per row, summing to 1."""
    if n_in > 1:
        period = 2.0 * (n_in - 1)
        c = torch.remainder(src, period)
        src = torch.where(c > n_in - 1, period - c, c)
    grid = torch.arange(n_in, dtype=torch.float32, device=src.device)
    w = torch.clamp_min(1.0 - torch.abs(src[..., None] - grid), 0.0)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-8)
    return w.to(dtype)


def _product_sum(equation: str, img: torch.Tensor, wt: torch.Tensor
                 ) -> torch.Tensor:
    """einsum of the bf16-rounded image and weights, in fp32: each product
    of two bf16 values is exact in fp32 (and in TF32), and every output
    sums at most two non-zero products, so the result does not depend on
    the order of the sum."""
    return torch.einsum(equation, img.to(torch.bfloat16).float(),
                        wt.float())


def _axes(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device))


def _shear_x_grouped(img: torch.Tensor, alpha: torch.Tensor,
                     cy: float) -> torch.Tensor:
    """Horizontal shear about row ``cy``, one factor per group:
    out[..., y, x] = in[..., y, x - a (y - cy)].  img [G, Bg, C, H, W],
    alpha [G]; the weights are [G, H, W_out, W_in]."""
    h, w = img.shape[-2:]
    ys, xs = _axes(h, w, img.device)
    src = xs[None, None, :] - alpha[:, None, None] * (ys[None, :, None] - cy)
    return _product_sum("gbchw,ghvw->gbchv", img, _interp_weights(src, w))


def _shear_y_grouped(img: torch.Tensor, beta: torch.Tensor,
                     cx: float) -> torch.Tensor:
    """Vertical shear about column ``cx``, one factor per group; the
    weights are [G, H_out, W, H_in]."""
    h, w = img.shape[-2:]
    ys, xs = _axes(h, w, img.device)
    src = ys[None, :, None] - beta[:, None, None] * (xs[None, None, :] - cx)
    return _product_sum("gbchw,gvwh->gbcvw", img, _interp_weights(src, h))


def rotate_shear3_grouped(img: torch.Tensor, angles: torch.Tensor,
                          cy: float, cx: float) -> torch.Tensor:
    """Rotate [B, C, H, W] about (cx, cy) with G = len(angles) angles
    (radians; contiguous groups of B/G samples share one) by the Paeth
    decomposition R = ShearX(-tan(a/2)) . ShearY(sin a) . ShearX(-tan(a/2)).
    The coordinate map composes to exactly ``_rotation_about``.  Returns
    fp32."""
    b, g = img.shape[0], angles.shape[0]
    grouped = img.reshape((g, b // g) + tuple(img.shape[1:]))
    alpha = -torch.tan(angles / 2.0)
    beta = torch.sin(angles)
    grouped = _shear_x_grouped(grouped, alpha, cy)
    grouped = _shear_y_grouped(grouped, beta, cx)
    grouped = _shear_x_grouped(grouped, alpha, cy)
    return grouped.reshape((b,) + tuple(grouped.shape[2:]))


def rotate_shear3(img: torch.Tensor, angle, cy: float, cx: float
                  ) -> torch.Tensor:
    """Rotate [B, C, H, W] by one ``angle`` (radians) about (cx, cy): the
    one-group case of ``rotate_shear3_grouped``.  Returns fp32."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=img.device)
    return rotate_shear3_grouped(img, angle.reshape(1), cy, cx)


def n_angle_groups(batch: int, requested: int) -> int:
    """Largest divisor of ``batch`` that is <= ``requested``."""
    g = max(1, min(int(requested), int(batch)))
    while batch % g:
        g -= 1
    return g


def crop_resize_mxu(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    cw: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """Per-example crop box (x0, y0, cw, ch: [B], input px) resized back to
    the full [B, C, H, W] by two weight contractions, half-pixel centers.
    Returns fp32."""
    h, w = img.shape[-2:]
    ys, xs = _axes(h, w, img.device)
    # output px u samples the input at origin + (u + .5) * crop / size - .5
    src_y = y0[:, None] + (ys[None, :] + 0.5) * (ch[:, None] / h) - 0.5
    src_x = x0[:, None] + (xs[None, :] + 0.5) * (cw[:, None] / w) - 0.5
    out = _product_sum("bchw,bvh->bcvw", img, _interp_weights(src_y, h))
    return _product_sum("bcvw,buw->bcvu", out, _interp_weights(src_x, w))


# --------------------------------------------------------------------------
# photometric
# --------------------------------------------------------------------------

def _gray(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, 1, H, W] luma, in the image dtype.  The weights
    are rounded to that dtype first, as JAX rounds its weakly typed
    constants (torch would multiply a bf16 tensor by the fp32 value)."""
    r, g, b = (torch.tensor(c, dtype=x.dtype).item()
               for c in (0.299, 0.587, 0.114))
    return (r * x[:, 0] + g * x[:, 1] + b * x[:, 2])[:, None]


def _rgb_to_hsv(rgb: torch.Tensor):
    """[B, 3, H, W] -> h, s, v, each [B, H, W]."""
    r, g, b = rgb.unbind(1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    s = torch.where(maxc > 0, d / torch.clamp_min(maxc, 1e-8), 0.0)
    d_safe = torch.clamp_min(d, 1e-8)
    rc = (maxc - r) / d_safe
    gc = (maxc - g) / d_safe
    bc = (maxc - b) / d_safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return h, s, v


def _select(i: torch.Tensor, values) -> torch.Tensor:
    """values[i] elementwise for i in [0, len(values)): jnp.select over
    i == 0, 1, ..."""
    out = values[-1]
    for k in range(len(values) - 2, -1, -1):
        out = torch.where(i == k, values[k], out)
    return out


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """h, s, v [B, H, W] -> [B, 3, H, W], with the JAX package's sector
    tables as written: its g and b differ from colorsys's in sectors 2, 3, 5
    (g) and 4, 5 (b)."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    return torch.stack([_select(i, (v, q, p, p, t, v)),
                        _select(i, (t, v, q, p, p, q)),
                        _select(i, (p, p, t, v, q, v))], 1)


def color_jitter_batch(imgs: torch.Tensor, brightness: torch.Tensor,
                       contrast: torch.Tensor, saturation: torch.Tensor,
                       hue: torch.Tensor, order: int,
                       apply: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ColorJitter on [B, 3, H, W] in [0, 1], in the image dtype: factors
    [B] per example (cast to the image dtype), the ops in the order
    ``JITTER_ORDERS[order]`` for the whole batch, and examples whose
    ``apply`` [B] is false come back unchanged (None: all apply)."""
    dt = imgs.dtype
    fb, fc, fs = (f.to(dt)[:, None, None, None]
                  for f in (brightness, contrast, saturation))
    fh = hue.to(dt)[:, None, None]

    def op_brightness(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def op_contrast(x):
        mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True,
                             dtype=torch.float32).to(dt)
        return torch.clamp((x - mean) * fc + mean, 0.0, 1.0)

    def op_saturation(x):
        g = _gray(x)
        return torch.clamp((x - g) * fs + g, 0.0, 1.0)

    def op_hue(x):
        h, s, v = _rgb_to_hsv(x)
        return torch.clamp(_hsv_to_rgb(torch.remainder(h + fh, 1.0), s, v),
                           0.0, 1.0)

    ops = (op_brightness, op_contrast, op_saturation, op_hue)
    out = imgs
    for i in JITTER_ORDERS[order]:
        out = ops[i](out)
    if apply is not None:
        out = torch.where(apply[:, None, None, None], out, imgs)
    return out


@dataclass
class JitterDraws:
    """The parameters of one ``color_jitter`` call: 0-dim factors and the
    op order, a permutation of (brightness, contrast, saturation, hue)."""
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    order: Tuple[int, ...]


def color_jitter_core(img: torch.Tensor, draws: JitterDraws) -> torch.Tensor:
    """ColorJitter on one [3, H, W] image in [0, 1] with ``draws`` (moved
    to the image's device): the one-image case of ``color_jitter_batch``."""
    factors = (f.reshape(1).to(img.device)
               for f in (draws.brightness, draws.contrast, draws.saturation,
                         draws.hue))
    return color_jitter_batch(img[None], *factors,
                              JITTER_ORDERS.index(tuple(draws.order)))[0]


def color_jitter(gen: torch.Generator, img: torch.Tensor,
                 brightness: float = 0.5, contrast: float = 0.2,
                 saturation: float = 0.5, hue: float = 0.1,
                 host_gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """torchvision-style ColorJitter on one [3, H, W] image in [0, 1]:
    factors uniform in 1 +- (brightness, contrast, saturation) and hue
    +-hue from ``gen``, the ops in a random order from ``host_gen`` (a CPU
    generator; defaults to ``gen`` when that is on the CPU)."""
    host_gen = _host(gen, host_gen)
    draws = JitterDraws(
        _uniform(gen, 1, 1 - brightness, 1 + brightness)[0],
        _uniform(gen, 1, 1 - contrast, 1 + contrast)[0],
        _uniform(gen, 1, 1 - saturation, 1 + saturation)[0],
        _uniform(gen, 1, -hue, hue)[0],
        tuple(torch.randperm(4, generator=host_gen).tolist()))
    return color_jitter_core(img, draws)


# --------------------------------------------------------------------------
# CLAHE
# --------------------------------------------------------------------------

def clahe_luma(img: torch.Tensor, clip_limit: torch.Tensor,
               tiles: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of the luma of
    [B, 3, H, W] in [0, 1] (fp32), one clip limit per example ([B]): per
    tile a 256-bin histogram, clipped at ``clip * tile_area / 256`` with
    the excess spread evenly, its CDF as a LUT, and each pixel's luma
    interpolated bilinearly between the LUTs of the four nearest tile
    centers; the RGB pixel is scaled by new / old luma.  H and W must be
    divisible by ``tiles``.  The JAX package's ``clahe_luma`` is this for
    one example."""
    b, _, h, w = img.shape
    th, tw = h // tiles, w // tiles
    area = th * tw
    bins = 256
    dev = img.device

    r, g, bl = img.unbind(1)
    y = 0.299 * r + 0.587 * g + 0.114 * bl                   # [B, H, W]
    y8 = torch.clamp(torch.round(y * 255.0), 0, 255).to(torch.int64)

    # histograms by index_add_ (counts are exact in fp32; no host sync)
    rows = torch.arange(h, device=dev) // th
    cols = torch.arange(w, device=dev) // tw
    tile = rows[:, None] * tiles + cols[None, :]             # [H, W]
    first = torch.arange(b, device=dev)[:, None, None] * (tiles * tiles)
    idx = ((first + tile) * bins + y8).reshape(-1)
    hist = torch.zeros(b * tiles * tiles * bins, dtype=torch.float32,
                       device=dev).index_add_(
        0, idx, torch.ones(idx.numel(), dtype=torch.float32, device=dev))
    hist = hist.view(b, tiles * tiles, bins)

    limit = torch.clamp_min(clip_limit * area / bins, 1.0)[:, None, None]
    clipped = torch.minimum(hist, limit)
    excess = (hist - clipped).sum(-1, keepdim=True)
    clipped = clipped + excess / bins
    cdf = torch.cumsum(clipped, -1)
    lut = torch.round(cdf * ((bins - 1.0) / area)).reshape(b, -1)

    ys, xs = _axes(h, w, dev)
    fy = torch.clamp(ys / th - 0.5, 0.0, tiles - 1.0)[:, None]
    fx = torch.clamp(xs / tw - 0.5, 0.0, tiles - 1.0)[None, :]
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    wy = fy - y0
    wx = fx - x0
    y1 = torch.clamp_max(y0 + 1, tiles - 1)
    x1 = torch.clamp_max(x0 + 1, tiles - 1)

    def sample(ty, tx):
        at = ((ty * tiles + tx) * bins + y8).reshape(b, -1)
        return torch.gather(lut, 1, at).view(b, h, w)

    v = (sample(y0, x0) * (1 - wy) * (1 - wx)
         + sample(y0, x1) * (1 - wy) * wx
         + sample(y1, x0) * wy * (1 - wx)
         + sample(y1, x1) * wy * wx) / 255.0

    scale = v / torch.clamp_min(y, 1e-6)
    out = torch.clamp(img * scale[:, None], 0.0, 1.0)
    return torch.where(y[:, None] > 1e-6, out, img)


def clahe_luma_batch(imgs: torch.Tensor, apply: torch.Tensor,
                     clip_limit: torch.Tensor, tiles: int = 8
                     ) -> torch.Tensor:
    """Per-example CLAHE where ``apply`` [B] holds, with clip limits [B]."""
    return torch.where(apply[:, None, None, None],
                       clahe_luma(imgs, clip_limit, tiles), imgs)


# --------------------------------------------------------------------------
# samplers and the full pipeline
# --------------------------------------------------------------------------

@dataclass
class AugmentDraws:
    """The random parameters of one ``augment_batch`` call, on the batch's
    device (``jitter_order`` is a host int)."""
    angles: torch.Tensor                  # [G] radians
    rotate: torch.Tensor                  # [B] bool
    brightness: torch.Tensor              # [B] jitter factors
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    jitter_order: int                     # index into JITTER_ORDERS
    jitter: Optional[torch.Tensor]        # [B] bool, None: all apply
    x0: torch.Tensor                      # [B] crop box, input px
    y0: torch.Tensor
    cw: torch.Tensor
    ch: torch.Tensor
    clahe: Optional[torch.Tensor] = None       # [B] bool, None: no CLAHE
    clahe_clip: Optional[torch.Tensor] = None  # [B]


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo


def _sample_crop(gen: torch.Generator, b: int, h: int, w: int,
                 scale_range: Sequence[float], ratio_range: Sequence[float]):
    """RandomResizedCrop boxes (x0, y0, cw, ch), each [B], torchvision-style:
    an area fraction and a log-uniform aspect ratio."""
    area = h * w * _uniform(gen, b, scale_range[0], scale_range[1])
    aspect = torch.exp(_uniform(gen, b, math.log(ratio_range[0]),
                                math.log(ratio_range[1])))
    cw = torch.clamp(torch.sqrt(area * aspect), 8.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 8.0, h)
    x0 = _uniform(gen, b, 0.0, 1.0) * (w - cw)
    y0 = _uniform(gen, b, 0.0, 1.0) * (h - ch)
    return x0, y0, cw, ch


@dataclass
class PhotometricDraws:
    """The random parameters of the SPM train step's photometric
    augmentation (``spm_photometric_core``); fields as in
    ``AugmentDraws``."""
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    jitter_order: int
    jitter: Optional[torch.Tensor]
    clahe: Optional[torch.Tensor] = None
    clahe_clip: Optional[torch.Tensor] = None


def _host(gen: torch.Generator,
          host_gen: Optional[torch.Generator]) -> torch.Generator:
    if host_gen is None:
        if gen.device.type != "cpu":
            raise ValueError("the jitter order is drawn on the host: pass a "
                             "CPU host_gen beside a device generator")
        host_gen = gen
    return host_gen


def sample_photometric(gen: torch.Generator, batch: int,
                       jitter_params: Sequence[float] = (0.5, 0.2, 0.5, 0.1),
                       clahe_prob: float = 0.0, jitter_prob: float = 0.5,
                       host_gen: Optional[torch.Generator] = None
                       ) -> PhotometricDraws:
    """CLAHE with probability ``clahe_prob`` and a clip limit uniform in
    [1, 4]; jitter factors uniform in 1 +- (b, c, s) and hue +-h, one of
    the 24 orders (from ``host_gen``, see ``sample_augment``), applied with
    ``jitter_prob``."""
    host_gen = _host(gen, host_gen)
    b = int(batch)
    clahe = clahe_clip = None
    if clahe_prob > 0:
        clahe = _uniform(gen, b, 0.0, 1.0) < clahe_prob
        clahe_clip = _uniform(gen, b, 1.0, 4.0)
    fb, fc, fs, fh = jitter_params
    factors = (_uniform(gen, b, 1 - fb, 1 + fb),
               _uniform(gen, b, 1 - fc, 1 + fc),
               _uniform(gen, b, 1 - fs, 1 + fs), _uniform(gen, b, -fh, fh))
    jitter = (_uniform(gen, b, 0.0, 1.0) < jitter_prob
              if jitter_prob < 1.0 else None)
    order = int(torch.randint(len(JITTER_ORDERS), (1,), generator=host_gen))
    return PhotometricDraws(*factors, order, jitter, clahe, clahe_clip)


def sample_augment(gen: torch.Generator, batch: int, out_hw: Sequence[int],
                   rotate_limit: float = 40.0,
                   scale_range: Sequence[float] = (0.4, 1.0),
                   ratio_range: Sequence[float] = (0.4, 1.6),
                   jitter_params: Sequence[float] = (0.5, 0.2, 0.5, 0.1),
                   clahe_prob: float = 0.0, rotate_prob: float = 0.5,
                   jitter_prob: float = 0.5, angle_groups: int = 16,
                   host_gen: Optional[torch.Generator] = None
                   ) -> AugmentDraws:
    """Draw one batch's augmentation parameters: per-example tensors from
    ``gen`` (on the batch's device), the jitter order from ``host_gen`` (a
    CPU generator; defaults to ``gen`` when that is on the CPU).  The
    distributions are the JAX package's: G = n_angle_groups(B, angle_groups)
    angles uniform in +-rotate_limit degrees, each sample rotated with
    probability ``rotate_prob``; CLAHE and jitter as
    ``sample_photometric``; crops as ``_sample_crop``."""
    host_gen = _host(gen, host_gen)
    b = int(batch)
    h, w = int(out_hw[0]), int(out_hw[1])
    g = n_angle_groups(b, angle_groups)
    angles = _uniform(gen, g, -rotate_limit, rotate_limit) * math.pi / 180.0
    if rotate_prob >= 1.0:
        rotate = torch.ones(b, dtype=torch.bool, device=gen.device)
    else:
        rotate = _uniform(gen, b, 0.0, 1.0) < rotate_prob
    p = sample_photometric(gen, b, jitter_params, clahe_prob, jitter_prob,
                           host_gen)
    x0, y0, cw, ch = _sample_crop(gen, b, h, w, scale_range, ratio_range)
    return AugmentDraws(angles, rotate, p.brightness, p.contrast,
                        p.saturation, p.hue, p.jitter_order, p.jitter,
                        x0, y0, cw, ch, p.clahe, p.clahe_clip)


def replica_draws(draws, r: int, world: int):
    """The draws of rank ``r``'s rows ``r*b:(r+1)*b`` of a global batch of
    B = world*b samples, from ``draws`` (``AugmentDraws`` or
    ``PhotometricDraws``) of the whole batch: every rank draws for the
    global batch from identically seeded generators and keeps its rows, so
    N ranks augment as one process does.  Identity for one rank.

    The rotation shares one angle per contiguous group of B/G samples of
    the global batch.  Group and rank boundaries both fall on multiples of
    d = gcd(B/G, b), so the rank's rows are b/d runs of d samples, each in
    one global group: the rank rotates b/d groups of d with those groups'
    angles, whether it holds several groups or a part of one.  A sample's
    rotation does not depend on how the batch is grouped (every output
    sums two exact products, see ``_product_sum``)."""
    if world == 1:
        return draws
    batch = draws.brightness.shape[0]
    if batch % world:
        raise ValueError(f"batch {batch} is not divisible by the {world} "
                         f"ranks")
    b = batch // world
    out = {k: v[r * b:(r + 1) * b] if torch.is_tensor(v) else v
           for k, v in vars(draws).items()}
    if isinstance(draws, AugmentDraws):
        size = batch // draws.angles.shape[0]
        d = math.gcd(size, b)
        groups = torch.arange(r * b, (r + 1) * b, d,
                              device=draws.angles.device) // size
        out["angles"] = draws.angles[groups]
    return type(draws)(**out)


def spm_photometric_core(images_u8: torch.Tensor, draws: PhotometricDraws,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The SPM train step's augmentation (the JAX package's
    train/steps.py:166-177): uint8 [B, H, W, 3] -> /255 in fp32 -> CLAHE
    where drawn (fp32) -> cast to ``out_dtype`` -> color jitter.  No crop
    and no final clip: [B, 3, H, W] in ``out_dtype``."""
    imgs = normalize_batch(images_u8)
    if draws.clahe is not None:
        imgs = clahe_luma_batch(imgs, draws.clahe, draws.clahe_clip)
    return color_jitter_batch(imgs.to(out_dtype), draws.brightness,
                              draws.contrast, draws.saturation, draws.hue,
                              draws.jitter_order, draws.jitter)


def augment_batch_core(images_u8: torch.Tensor, joints: torch.Tensor,
                       vis: torch.Tensor, draws: AugmentDraws,
                       out_hw: Sequence[int],
                       out_dtype: torch.dtype = torch.float32):
    """The deterministic part of ``augment_batch``.  images_u8 uint8
    [B, H, W, 3], joints [B, K, 2] input px (fp32), vis [B, K] ->
    (images [B, 3, H, W] in [0, 1] as ``out_dtype``, joints, vis).

    Rotate where ``draws.rotate`` (joints ride each sample's effective
    rotation) -> CLAHE (fp32) -> color jitter in ``out_dtype`` -> crop and
    resize -> clip to [0, 1] (bf16-rounded weights can sum to slightly
    above 1) -> cast.  Joints that leave the frame become invisible."""
    b = images_u8.shape[0]
    h, w = int(out_hw[0]), int(out_hw[1])
    imgs = normalize_batch(images_u8)

    g = draws.angles.shape[0]
    per_sample = draws.angles[:, None].expand(g, b // g).reshape(b)
    eff_angle = torch.where(draws.rotate, per_sample, 0.0)
    rotated = rotate_shear3_grouped(imgs, draws.angles, h / 2.0, w / 2.0)
    imgs = torch.where(draws.rotate[:, None, None, None], rotated, imgs)
    joints = transform_points(_rotation_about(w / 2.0, h / 2.0, eff_angle),
                              joints)

    if draws.clahe is not None:
        imgs = clahe_luma_batch(imgs, draws.clahe, draws.clahe_clip)

    imgs = color_jitter_batch(imgs.to(out_dtype), draws.brightness,
                              draws.contrast, draws.saturation, draws.hue,
                              draws.jitter_order, draws.jitter)

    x0, y0, cw, ch = draws.x0, draws.y0, draws.cw, draws.ch
    imgs = torch.clamp(crop_resize_mxu(imgs, x0, y0, cw, ch), 0.0,
                       1.0).to(out_dtype)
    new_pts = torch.stack([(joints[..., 0] - x0[:, None]) * (w / cw)[:, None],
                           (joints[..., 1] - y0[:, None]) * (h / ch)[:, None]],
                          -1)
    inside = ((new_pts[..., 0] >= 0) & (new_pts[..., 0] < w)
              & (new_pts[..., 1] >= 0) & (new_pts[..., 1] < h))
    return imgs, new_pts, vis * inside.to(vis.dtype)


def augment_batch(gen: torch.Generator, images_u8: torch.Tensor,
                  joints: torch.Tensor, vis: torch.Tensor,
                  out_hw: Sequence[int], rotate_limit: float = 40.0,
                  scale_range: Sequence[float] = (0.4, 1.0),
                  ratio_range: Sequence[float] = (0.4, 1.6),
                  jitter_params: Sequence[float] = (0.5, 0.2, 0.5, 0.1),
                  clahe_prob: float = 0.0,
                  out_dtype: torch.dtype = torch.float32,
                  rotate_prob: float = 0.5, jitter_prob: float = 0.5,
                  angle_groups: int = 16,
                  host_gen: Optional[torch.Generator] = None):
    """Train-time batch augmentation (the JAX package's ``augment_batch``,
    same arguments, with torch generators for its key): ``sample_augment``
    then ``augment_batch_core``."""
    draws = sample_augment(gen, images_u8.shape[0], out_hw, rotate_limit,
                           scale_range, ratio_range, jitter_params,
                           clahe_prob, rotate_prob, jitter_prob,
                           angle_groups, host_gen)
    return augment_batch_core(images_u8, joints, vis, draws, out_hw,
                              out_dtype)
