"""The port's augmentation (pytorch_pose_estimation_tpu_torch/ops/image.py)
against the JAX package's ops/image.py on the CPU.  Each deterministic core
gets the draws that the JAX function takes from its key: ``jax_draws``
repeats ``augment_batch``'s key splits (ops/image.py:654, :401, :553-555,
:590, :684).  Images are numpy-seeded; the port is NCHW, JAX NHWC.

Tolerances:
* interpolation weights, rotation, crop and CLAHE: exact.  Every output of
  a resampling contraction sums at most two exact bf16 x bf16 products, so
  its fp32 value does not depend on the order of the sum; CLAHE's counts
  are integers and its LUTs came out identical;
* color jitter: exact at bf16, 1e-6 at fp32 (the contrast mean, a sum of
  H*W fp32 values, is taken in another order).  The JAX function runs op
  by op (``jax.disable_jit``) here: jitted on the CPU, XLA fuses the
  saturation into the hue op twice with different FMA contraction, so
  ``r == max(r, g, b)`` can fail for a pixel that is pure red, and its hue
  lands 5/6 of a turn away, a different color;
* joints: 1e-4 px (cos, sin and a 2x2 product may round differently),
  visibility equal except within 1e-3 px of the frame's edge;
* the whole ``augment_batch`` from one key: as its parts, the JAX side
  again op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_pose_estimation_tpu.ops import image as J
from pytorch_pose_estimation_tpu_torch.ops import image as P

B, H, W = 4, 32, 24  # H, W divisible by CLAHE's 8 tiles
DEFAULTS = dict(rotate_limit=40.0, scale_range=(0.4, 1.0),
                ratio_range=(0.4, 1.6), jitter_params=(0.5, 0.2, 0.5, 0.1),
                clahe_prob=0.0, rotate_prob=0.5, jitter_prob=0.5,
                angle_groups=16)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))))


def _t(x):
    return torch.from_numpy(np.array(x).reshape(-1))


def _jax_clahe_draws(k_cl, b, clahe_prob):
    """``clahe_luma_batch``'s per-example draws from its key."""
    def one(kk):
        k_do, k_clip = jax.random.split(kk)
        return (jax.random.uniform(k_do, ()) < clahe_prob,
                jax.random.uniform(k_clip, (), minval=1.0, maxval=4.0))
    do, clip = jax.vmap(one)(jax.random.split(k_cl, b))
    return _t(do), _t(clip)


def _jax_jitter_draws(k_col, b, jitter_params, jitter_prob):
    """``color_jitter_batch``'s draws from its key: the four factors, the
    order and the apply mask."""
    fb, fc, fs, fh = jitter_params
    k_b, k_c, k_s, k_h, k_perm, k_apply = jax.random.split(k_col, 6)
    shape = (b, 1, 1, 1)
    factors = [jax.random.uniform(k, shape, minval=lo, maxval=hi)
               for k, lo, hi in ((k_b, 1 - fb, 1 + fb), (k_c, 1 - fc, 1 + fc),
                                 (k_s, 1 - fs, 1 + fs))]
    factors.append(jax.random.uniform(k_h, (b, 1, 1), minval=-fh, maxval=fh))
    order = int(jax.random.randint(k_perm, (), 0, 24))
    jitter = (_t(jax.random.uniform(k_apply, shape) < jitter_prob)
              if jitter_prob < 1.0 else None)
    return [_t(f) for f in factors], order, jitter


def jax_draws(key, b, out_hw, rotate_limit=40.0, scale_range=(0.4, 1.0),
              ratio_range=(0.4, 1.6), jitter_params=(0.5, 0.2, 0.5, 0.1),
              clahe_prob=0.0, rotate_prob=0.5, jitter_prob=0.5,
              angle_groups=16) -> P.AugmentDraws:
    """The draws that the JAX ``augment_batch(key, ...)`` makes, as the
    port's ``AugmentDraws`` (CPU tensors)."""
    h, w = out_hw
    k_rot, k_rapply, k_crop, k_col, k_cl = jax.random.split(key, 5)
    g = J.n_angle_groups(b, angle_groups)
    angles = jax.random.uniform(k_rot, (g,), minval=-rotate_limit,
                                maxval=rotate_limit) * jnp.pi / 180.0
    if rotate_prob >= 1.0:
        rotate = np.ones(b, bool)
    else:
        rotate = np.asarray(jax.random.uniform(k_rapply, (b,)) < rotate_prob)
    clahe = clahe_clip = None
    if clahe_prob > 0:
        clahe, clahe_clip = _jax_clahe_draws(k_cl, b, clahe_prob)
    factors, order, jitter = _jax_jitter_draws(k_col, b, jitter_params,
                                               jitter_prob)
    x0, y0, cw, ch = jax.vmap(lambda kk: J._sample_crop(
        kk, h, w, scale_range, ratio_range))(jax.random.split(k_crop, b))
    return P.AugmentDraws(_t(angles), _t(rotate), *factors, order, jitter,
                          _t(x0), _t(y0), _t(cw), _t(ch), clahe, clahe_clip)


def jax_spm_draws(key, b, jitter_params=(0.5, 0.2, 0.5, 0.1),
                  clahe_prob=0.0, jitter_prob=0.5) -> P.PhotometricDraws:
    """The draws of the JAX SPM train step's default augmentation
    (train/steps.py:168-177: ``k_cl, k_col = split(rng)``) as the port's
    ``PhotometricDraws``."""
    k_cl, k_col = jax.random.split(key)
    clahe = clahe_clip = None
    if clahe_prob > 0:
        clahe, clahe_clip = _jax_clahe_draws(k_cl, b, clahe_prob)
    factors, order, jitter = _jax_jitter_draws(k_col, b, jitter_params,
                                               jitter_prob)
    return P.PhotometricDraws(*factors, order, jitter, clahe, clahe_clip)


def _images(seed=0, b=B, h=H, w=W):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def test_interp_weights_match_jax():
    src = (np.random.RandomState(0).randn(6, 9) * 40).astype(np.float32)
    src[0, :4] = [0.0, 23.0, 46.0, -23.0]  # integers and the fold's ends
    for n in (1, 24, 32):
        want = np.asarray(J._interp_weights(jnp.asarray(src), n)
                          .astype(jnp.float32))
        got = P._interp_weights(torch.from_numpy(src), n)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_rotation_grouped_matches_jax(groups):
    imgs = _images(1)
    angles = np.random.RandomState(2).uniform(-0.7, 0.7, groups) \
        .astype(np.float32)
    want = J.rotate_shear3_grouped(jnp.asarray(imgs), jnp.asarray(angles),
                                   H / 2.0, W / 2.0)
    got = P.rotate_shear3_grouped(nchw(imgs), torch.from_numpy(angles),
                                  H / 2.0, W / 2.0)
    np.testing.assert_array_equal(got.numpy(), nchw(want).numpy())
    assert np.abs(got.numpy() - nchw(imgs).numpy()).max() > 0.1  # it moved


def test_crop_matches_jax():
    imgs = _images(3)
    key = jax.random.PRNGKey(4)
    boxes = jax.vmap(lambda kk: J._sample_crop(kk, H, W, (0.4, 1.0),
                                               (0.4, 1.6)))(
        jax.random.split(key, B))
    want = J.crop_resize_mxu(jnp.asarray(imgs), *boxes)
    got = P.crop_resize_mxu(nchw(imgs), *map(_t, boxes))
    np.testing.assert_array_equal(got.numpy(), nchw(want).numpy())


# keys whose jitter draws orders 1, 12, 0, 18, 4 and 7, each with applied
# and skipped examples
JITTER_SEEDS = [0, 1, 3, 4, 5, 7]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", JITTER_SEEDS)
def test_color_jitter_matches_jax(seed, dtype):
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, B, (H, W))
    assert 0 < int(draws.jitter.sum()) < B
    k_col = jax.random.split(key, 5)[3]
    imgs = _images(5)
    with jax.disable_jit():
        want = J.color_jitter_batch(k_col, jnp.asarray(imgs).astype(dtype),
                                    apply_prob=0.5).astype(jnp.float32)
    got = P.color_jitter_batch(nchw(imgs).to(getattr(torch, dtype)),
                               draws.brightness, draws.contrast,
                               draws.saturation, draws.hue,
                               draws.jitter_order, draws.jitter)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    np.testing.assert_allclose(got, nchw(want).numpy(), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0)
    skipped = ~draws.jitter.numpy()
    np.testing.assert_array_equal(got[skipped],
                                  nchw(imgs).to(getattr(torch, dtype))
                                  .float().numpy()[skipped])


def test_clahe_luma_matches_jax():
    imgs = _images(6)
    imgs[1, :8, :6] = 0.0  # a black tile (luma 0 keeps the pixel)
    clips = np.asarray([1.0, 2.5, 4.0, 3.3], np.float32)
    want = np.stack([np.asarray(J.clahe_luma(jnp.asarray(imgs[i]), clips[i]))
                     for i in range(B)])
    got = P.clahe_luma(nchw(imgs), torch.from_numpy(clips))
    np.testing.assert_array_equal(got.numpy(), nchw(want).numpy())
    apply = torch.tensor([True, False, True, False])
    masked = P.clahe_luma_batch(nchw(imgs), apply, torch.from_numpy(clips))
    np.testing.assert_array_equal(masked[1].numpy(), nchw(imgs)[1].numpy())
    np.testing.assert_array_equal(masked[0].numpy(), got[0].numpy())


def _batch(seed, b=B, k=17):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, H, W, 3), dtype=np.uint8)
    joints = np.stack([rng.uniform(0, W, (b, k)), rng.uniform(0, H, (b, k))],
                      -1).astype(np.float32)
    vis = (rng.rand(b, k) > 0.2).astype(np.float32)
    return images, joints, vis


def _check_joints(got_pts, got_vis, want_pts, want_vis):
    np.testing.assert_allclose(got_pts, want_pts, rtol=0, atol=1e-4)
    edge = ((np.abs(want_pts[..., 0]) < 1e-3) | (np.abs(want_pts[..., 0] - W)
                                                  < 1e-3)
            | (np.abs(want_pts[..., 1]) < 1e-3)
            | (np.abs(want_pts[..., 1] - H) < 1e-3))
    np.testing.assert_array_equal(got_vis[~edge], want_vis[~edge])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 3])
def test_augment_batch_matches_jax(seed, out_dtype):
    """The whole pipeline from one key, device CLAHE on; the joints and
    their visibility ride the same draws."""
    images, joints, vis = _batch(seed + 10)
    key = jax.random.PRNGKey(seed)
    opts = dict(DEFAULTS, clahe_prob=0.5, angle_groups=2)
    with jax.disable_jit():
        want = J.augment_batch(
            key, jnp.asarray(images), jnp.asarray(joints), jnp.asarray(vis),
            (H, W), opts["rotate_limit"], opts["scale_range"],
            opts["ratio_range"], opts["jitter_params"], opts["clahe_prob"],
            getattr(jnp, out_dtype), opts["rotate_prob"],
            opts["jitter_prob"], opts["angle_groups"])
    draws = jax_draws(key, B, (H, W), **opts)
    got = P.augment_batch_core(torch.from_numpy(images),
                               torch.from_numpy(joints),
                               torch.from_numpy(vis), draws, (H, W),
                               getattr(torch, out_dtype))
    assert got[0].dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(
        got[0].float().numpy(), nchw(want[0].astype(jnp.float32)).numpy(),
        rtol=0, atol=1e-6 if out_dtype == "float32" else 0)
    _check_joints(got[1].numpy(), got[2].numpy(), np.asarray(want[1]),
                  np.asarray(want[2]))
    assert 0 < float(got[2].sum()) < float(vis.sum())  # some left the frame


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spm_photometric_matches_jax(dtype):
    """The SPM train step's default augmentation (train/steps.py:166-177):
    /255, CLAHE in fp32, then the jitter in the model's dtype; the JAX side
    op by op.  Exact at bf16, 1e-6 at fp32 (the contrast mean)."""
    images = _batch(12)[0]
    key = jax.random.PRNGKey(4)
    k_cl, k_col = jax.random.split(key)
    with jax.disable_jit():
        x = J.clahe_luma_batch(k_cl, jnp.asarray(images).astype(jnp.float32)
                               / 255.0, 0.5)
        want = J.color_jitter_batch(k_col, x.astype(dtype), apply_prob=0.5)
    draws = jax_spm_draws(key, B, clahe_prob=0.5)
    assert 0 < int(draws.clahe.sum()) < B
    got = P.spm_photometric_core(torch.from_numpy(images), draws,
                                 getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), nchw(want.astype(jnp.float32)).numpy(), rtol=0,
        atol=1e-6 if dtype == "float32" else 0)


def test_joints_ride_rotation_and_crop():
    """Joints only, with every sample rotated (angles large enough to push
    joints out of the frame) and strong crops."""
    images, joints, vis = _batch(7, b=8)
    images = np.concatenate([images, images])[:8]
    key = jax.random.PRNGKey(9)
    opts = dict(DEFAULTS, rotate_prob=1.0, scale_range=(0.2, 0.5),
                angle_groups=4)
    args = (opts["rotate_limit"], opts["scale_range"], opts["ratio_range"],
            opts["jitter_params"], 0.0, jnp.float32, 1.0, 0.5, 4)
    _, want_pts, want_vis = J.augment_batch(
        key, jnp.asarray(images), jnp.asarray(joints), jnp.asarray(vis),
        (H, W), *args)
    draws = jax_draws(key, 8, (H, W), **opts)
    _, pts, new_vis = P.augment_batch_core(
        torch.from_numpy(images), torch.from_numpy(joints),
        torch.from_numpy(vis), draws, (H, W))
    _check_joints(pts.numpy(), new_vis.numpy(), np.asarray(want_pts),
                  np.asarray(want_vis))
    assert float(new_vis.sum()) < 0.8 * float(vis.sum())


# --------------------------------------------------------------------------
# the port's samplers: distributions (after tests/test_augment_distribution)
# --------------------------------------------------------------------------

def _port_draws(n, batch=16, **opts):
    gen = torch.Generator().manual_seed(0)
    return [P.sample_augment(gen, batch, (H, W), **dict(DEFAULTS, **opts))
            for _ in range(n)]


def _recover_angles(draws_list, h=32, w=32):
    """Each sample's effective angle, read back from a joint on a circle
    around the center after the port's core (identity crop)."""
    out = []
    for d in draws_list:
        b = d.rotate.shape[0]
        d.x0, d.y0 = torch.zeros(b), torch.zeros(b)
        d.cw, d.ch = torch.full((b,), float(w)), torch.full((b,), float(h))
        joints = torch.tensor([[[w / 2 + 10.0, h / 2]]]).repeat(b, 1, 1)
        _, pts, _ = P.augment_batch_core(
            torch.zeros(b, h, w, 3, dtype=torch.uint8), joints,
            torch.ones(b, 1), d, (h, w))
        off = pts[:, 0].numpy() - [w / 2, h / 2]
        out.append(np.degrees(np.arctan2(off[:, 1], off[:, 0])))
    return np.asarray(out)


def test_sampler_rotation_rate_and_angles():
    """Apply rate p=0.5 per sample, angles uniform in +-40 degrees, shared
    by contiguous groups of B/G samples, several distinct angles a batch."""
    draws = _port_draws(40, angle_groups=8)
    angles = _recover_angles(draws)
    applied = np.abs(angles) > 1e-4
    assert abs(applied.mean() - 0.5) < 0.08
    got = angles[applied]
    assert np.abs(got).max() <= 40.0 + 1e-3
    assert abs(got.mean()) < 5.0 and abs(got.std() - 80 / 12 ** 0.5) < 4.0
    hist, _ = np.histogram(got, bins=4, range=(-40, 40))
    assert hist.min() > 0.25 * got.size / 4
    mixed = sum(0 < row.sum() < row.size for row in applied)
    assert mixed >= 36  # per-sample apply, not per batch
    for d in draws[:10]:
        a = d.angles.numpy()
        assert a.shape == (8,) and len(np.unique(np.round(a, 5))) >= 6
    both = _recover_angles(_port_draws(10, angle_groups=8, rotate_prob=1.0))
    np.testing.assert_allclose(both[:, 0::2], both[:, 1::2], atol=1e-2)


def test_sampler_jitter_clahe_and_crop_distributions():
    draws = _port_draws(60)
    jit = np.concatenate([d.jitter.numpy() for d in draws])
    assert abs(jit.mean() - 0.5) < 0.05
    for name, lo, hi in (("brightness", 0.5, 1.5), ("contrast", 0.8, 1.2),
                         ("saturation", 0.5, 1.5), ("hue", -0.1, 0.1)):
        v = np.concatenate([getattr(d, name).numpy() for d in draws])
        assert lo <= v.min() and v.max() <= hi, name
        assert abs(v.mean() - (lo + hi) / 2) < 0.03 * (hi - lo), name
    orders = [d.jitter_order for d in draws]
    assert min(orders) >= 0 and max(orders) < 24 and len(set(orders)) >= 15
    cw = np.concatenate([d.cw.numpy() for d in draws])
    ch = np.concatenate([d.ch.numpy() for d in draws])
    x0 = np.concatenate([d.x0.numpy() for d in draws])
    assert (cw >= 8).all() and (cw <= W).all() and (ch <= H).all()
    assert (x0 >= 0).all() and (x0 + cw <= W + 1e-4).all()
    area = cw * ch / (H * W)
    assert area.max() <= 1.0 + 1e-6 and np.median(area) > 0.35
    cl = _port_draws(60, clahe_prob=0.5)
    do = np.concatenate([d.clahe.numpy() for d in cl])
    clip = np.concatenate([d.clahe_clip.numpy() for d in cl])
    assert abs(do.mean() - 0.5) < 0.05
    assert 1.0 <= clip.min() and clip.max() <= 4.0
    assert _port_draws(1)[0].clahe is None
    assert _port_draws(1, jitter_prob=1.0)[0].jitter is None


def test_sampler_needs_a_host_generator_beside_a_device_one():
    class FakeDevice:
        type = "cuda"

    class Gen:
        device = FakeDevice()

    with pytest.raises(ValueError, match="host_gen"):
        P.sample_augment(Gen(), 4, (H, W))


def test_n_angle_groups_and_identity_crop():
    assert [P.n_angle_groups(b, g) for b, g in
            ((256, 16), (16, 8), (4, 8), (6, 4), (7, 8), (1, 8), (32, 1))] \
        == [16, 8, 4, 3, 7, 1, 1]
    # with scale 1 and ratio w/h the crop is the identity (ROADMAP item 6)
    images, joints, vis = _batch(11)
    gen = torch.Generator().manual_seed(1)
    out, pts, new_vis = P.augment_batch(
        gen, torch.from_numpy(images), torch.from_numpy(joints),
        torch.from_numpy(vis), (H, W), scale_range=(1.0, 1.0),
        ratio_range=(W / H, W / H), rotate_prob=0.0, jitter_prob=0.0)
    np.testing.assert_allclose(out.numpy(), nchw(images / 255.0).numpy(),
                               rtol=0, atol=2 ** -8)
    np.testing.assert_allclose(pts.numpy(), joints, rtol=0, atol=1e-3)
