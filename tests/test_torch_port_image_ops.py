"""The JAX package's per-example image ops against the port's, on the CPU:
``affine_warp``, ``sample_train_affine`` (the port's sampler and
``train_affine_core``), ``rotate_shear3`` and ``color_jitter`` (the port's
sampler and ``color_jitter_core``).  Images are numpy-seeded in [0, 1]; the
port is CHW / NCHW, JAX HWC / NHWC.  The random ops get the draws that the
JAX function takes from its key (its ``jax.random.split`` repeated here).
The JAX functions run eagerly, op by op, as its own tests call them.

Tolerances: ``affine_warp`` 1e-6 (the same fp32 ops in the same order);
the affine matrix 1e-6 of its largest entry (cos, sin and a 3x3 product
may round differently); ``rotate_shear3`` 1e-5 against JAX and 1e-6
against ``rotate_shear3_grouped`` at one group; color jitter 1e-6 (the
contrast mean, a sum of H*W fp32 values, is taken in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu.ops import image as J
from pytorch_pose_estimation_tpu_torch.ops import image as P

H, W = 24, 20


def _img(seed, h=H, w=W):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _chw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, -3)))


def _hwc(x):
    return np.moveaxis(x.numpy(), -3, -1)


# --------------------------------------------------------------------------
# affine_warp
# --------------------------------------------------------------------------

def _rotation_inv(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    cx, cy = W / 2.0, H / 2.0
    return [[c, s, cx - c * cx - s * cy], [-s, c, cy + s * cx - c * cy]]


WARPS = {
    "identity": ([[1, 0, 0], [0, 1, 0]], (H, W)),
    "rotation": (_rotation_inv(23.0), (H, W)),
    "crop": ([[0.45, 0, 3.25], [0, 0.6, 5.5]], (16, 18)),
    "out_of_range_taps": ([[1.7, 0.3, -9.0], [-0.2, 1.9, -13.5]], (30, 26)),
}


@pytest.mark.parametrize("case", sorted(WARPS))
def test_affine_warp_matches_jax(case):
    inv, out_hw = WARPS[case]
    inv = np.asarray(inv, np.float32)
    img = _img(0)
    want = np.asarray(J.affine_warp(jnp.asarray(img), jnp.asarray(inv),
                                    out_hw))
    got = P.affine_warp(_chw(img), torch.from_numpy(inv), out_hw)
    assert got.shape == (3,) + out_hw
    np.testing.assert_allclose(_hwc(got), want, rtol=0, atol=1e-6)
    if case == "identity":
        np.testing.assert_array_equal(_hwc(got), img)


# --------------------------------------------------------------------------
# sample_train_affine
# --------------------------------------------------------------------------

AFFINE = dict(rotate_limit=30.0, scale_range=(0.6, 1.0),
              ratio_range=(0.75, 1.33))


def _jax_affine_draws(key, rotate_limit, scale_range, ratio_range):
    """``sample_train_affine``'s five uniforms from its key
    (ops/image.py:129-142)."""
    k_rot, k_area, k_ratio, k_x, k_y = jax.random.split(key, 5)
    u = [jax.random.uniform(k_rot, (), minval=-rotate_limit,
                            maxval=rotate_limit),
         jax.random.uniform(k_area, (), minval=scale_range[0],
                            maxval=scale_range[1]),
         jax.random.uniform(k_ratio, (), minval=jnp.log(ratio_range[0]),
                            maxval=jnp.log(ratio_range[1])),
         jax.random.uniform(k_x, (), minval=0.0, maxval=1.0),
         jax.random.uniform(k_y, (), minval=0.0, maxval=1.0)]
    return P.TrainAffineDraws(*(torch.tensor(float(v), dtype=torch.float32)
                                for v in u))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_affine_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(J.sample_train_affine(key, (H, W), **AFFINE))
    got = P.train_affine_core(_jax_affine_draws(key, **AFFINE), (H, W))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_sampled_affine_maps_points_as_affine_warp_moves_pixels():
    """The port's sampler is seeded and in range; ``transform_points`` of
    the forward matrix and ``affine_warp`` by its inverse agree: warped, a
    ramp image carries each output pixel's source coordinates (bilinear
    interpolation of a linear ramp is exact away from the reflected
    border), which the matrix maps back onto the pixel."""
    draws = P.sample_train_affine(torch.Generator().manual_seed(4), (H, W),
                                  **AFFINE)
    again = P.sample_train_affine(torch.Generator().manual_seed(4), (H, W),
                                  **AFFINE)
    assert all(torch.equal(a, b) for a, b in zip(vars(draws).values(),
                                                 vars(again).values()))
    assert abs(float(draws.angle)) <= 30.0
    assert 0.6 <= float(draws.scale) <= 1.0
    assert 0.0 <= float(draws.x) < 1.0 and 0.0 <= float(draws.y) < 1.0
    m = P.train_affine_core(draws, (H, W))
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    inv = P._invert(m)
    src = P.affine_warp(torch.stack([xs, ys]), inv, (H, W))
    pixels = torch.stack([xs, ys], -1)
    exact = P.transform_points(inv, pixels)
    inside = ((exact[..., 0] > 0) & (exact[..., 0] < W - 1)
              & (exact[..., 1] > 0) & (exact[..., 1] < H - 1))
    assert inside.sum() > H * W // 4
    back = P.transform_points(m, src.permute(1, 2, 0)[inside])
    torch.testing.assert_close(back, pixels[inside], rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# rotate_shear3
# --------------------------------------------------------------------------

@pytest.mark.parametrize("deg", [-35.0, 12.5, 90.0])
def test_rotate_shear3_matches_jax_and_the_grouped_rotation(deg):
    imgs = np.random.RandomState(5).rand(2, H, W, 3).astype(np.float32)
    angle = np.float32(np.deg2rad(deg))
    cy, cx = H / 2.0, W / 2.0
    want = np.asarray(J.rotate_shear3(jnp.asarray(imgs), angle, cy, cx))
    x = torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)))
    got = P.rotate_shear3(x, torch.tensor(angle), cy, cx)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)
    grouped = P.rotate_shear3_grouped(x, torch.tensor([angle]), cy, cx)
    torch.testing.assert_close(got, grouped, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# color_jitter
# --------------------------------------------------------------------------

JITTER = (0.5, 0.2, 0.5, 0.1)


def _jax_jitter_draws(key, brightness, contrast, saturation, hue):
    """``color_jitter``'s draws from its key (ops/image.py:341-348)."""
    k_b, k_c, k_s, k_h, k_perm = jax.random.split(key, 5)
    factors = [jax.random.uniform(k_b, (), minval=1 - brightness,
                                  maxval=1 + brightness),
               jax.random.uniform(k_c, (), minval=1 - contrast,
                                  maxval=1 + contrast),
               jax.random.uniform(k_s, (), minval=1 - saturation,
                                  maxval=1 + saturation),
               jax.random.uniform(k_h, (), minval=-hue, maxval=hue)]
    order = tuple(int(i) for i in jax.random.permutation(k_perm, 4))
    return P.JitterDraws(*(torch.tensor(float(f), dtype=torch.float32)
                           for f in factors), order)


def _keys_for_every_order():
    """For each of the 24 op orders, the first key whose draws take it."""
    found = {}
    seed = 0
    while len(found) < 24:
        perm = jax.random.permutation(
            jax.random.split(jax.random.PRNGKey(seed), 5)[4], 4)
        found.setdefault(tuple(int(i) for i in perm), seed)
        seed += 1
    return found


@pytest.fixture(scope="module")
def order_keys():
    return _keys_for_every_order()


@pytest.mark.parametrize("order", list(itertools.permutations(range(4))))
def test_color_jitter_matches_jax_in_every_order(order, order_keys):
    key = jax.random.PRNGKey(order_keys[order])
    img = _img(order_keys[order] + 10, 12, 10)
    draws = _jax_jitter_draws(key, *JITTER)
    assert draws.order == order
    with jax.disable_jit():
        want = np.asarray(J.color_jitter(key, jnp.asarray(img), *JITTER))
    got = P.color_jitter_core(_chw(img), draws)
    np.testing.assert_allclose(_hwc(got), want, rtol=0, atol=1e-6)


def test_color_jitter_sampler():
    """``color_jitter`` is its seeded draws through the core; the order is
    a permutation drawn on the host generator."""
    img = _chw(_img(7))
    got = P.color_jitter(torch.Generator().manual_seed(3), img, *JITTER)
    gen = torch.Generator().manual_seed(3)
    factors = [P._uniform(gen, 1, 1 - f, 1 + f)[0] for f in JITTER[:3]]
    hue = P._uniform(gen, 1, -JITTER[3], JITTER[3])[0]
    order = tuple(torch.randperm(4, generator=gen).tolist())
    want = P.color_jitter_core(img, P.JitterDraws(*factors, hue, order))
    assert torch.equal(got, want)
    assert not torch.equal(got, img) and 0.0 <= float(got.min()) \
        and float(got.max()) <= 1.0
