"""The one traffic generator: a traffic file's parameters and a seed in,
host arrays out.  The same seed gives the same arrays.

``cache`` traffic (train cells) is the train set that the device cache
holds: the configuration's ``train_instances`` (or the traffic's
``rows``) uint8 crops at its input size, made from a
block of ``distinct`` random crops repeated (a gather's traffic does not
depend on the pixels), and the labels of each row:

* ``"persons": [1, 1]`` (SBP, one person a crop): K joints uniform in the
  crop, each visible with probability ``visible``;
* ``"persons": [lo, hi]`` with ``max_persons`` (SPM): lo..hi persons an
  image, uniform; a center uniform inside ``margin`` of the border, the
  joints normal around it with ``spread`` px, clipped to the image, each
  present with probability ``visible`` (absent points are (0, 0)).

``pool`` traffic (serving cells) is ``pool`` distinct crops and a seeded
permutation of them, one crop a request; the requests go round it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), int(stream)])


def _hw(config: dict):
    size = config["input_size"]
    return (size, size) if isinstance(size, int) else tuple(size)


def _images(rng, n: int, distinct: int, hw: Sequence[int]) -> np.ndarray:
    """n uint8 crops [n, H, W, 3]: ``distinct`` random ones, repeated."""
    block = rng.integers(0, 256, (min(distinct, n),) + tuple(hw) + (3,),
                         dtype=np.uint8)
    out = np.empty((n,) + block.shape[1:], np.uint8)
    for start in range(0, n, len(block)):
        stop = min(start + len(block), n)
        out[start:stop] = block[:stop - start]
    return out


def cache_arrays(traffic: dict, config: dict, seed: int
                 ) -> Dict[str, np.ndarray]:
    """The cached train set's arrays, keyed as the model kind's batches."""
    n = int(traffic.get("rows", config["train_instances"]))
    h, w = _hw(config)
    k = int(config["num_keypoints"])
    rng = _rng(seed, 1)
    images = _images(rng, n, int(traffic["distinct"]), (h, w))
    visible = float(traffic["visible"])
    lo, hi = traffic["persons"]
    if config["kind"] == "sbp":
        joints = rng.uniform(0.0, 1.0, (n, k, 2)) * np.array([w, h])
        vis = (rng.uniform(size=(n, k)) < visible).astype(np.float32)
        return {"image": images, "joints": joints.astype(np.float32),
                "joints_vis": vis}
    p_max = int(config["max_persons"])
    margin, spread = float(traffic["margin"]), float(traffic["spread"])
    count = rng.integers(int(lo), int(hi) + 1, n)
    centers = margin + rng.uniform(0.0, 1.0, (n, p_max, 1, 2)) * \
        (np.array([w, h]) - 2.0 * margin)
    joints = centers + rng.normal(0.0, spread, (n, p_max, k, 2))
    joints = np.clip(joints, 1.0, np.array([w, h]) - 1.0)
    present = rng.uniform(size=(n, p_max, k)) < visible
    joints = np.where(present[..., None], joints, 0.0)
    real = np.arange(p_max)[None, :] < count[:, None]          # [n, P]
    centers = np.where(real[:, :, None, None], centers, 0.0)
    joints = np.where(real[:, :, None, None], joints, 0.0)
    return {"image": images, "joints": joints.astype(np.float32),
            "centers": centers.astype(np.float32)}


def request_pool(traffic: dict, config: dict, seed: int):
    """(crops uint8 [pool, H, W, 3], the order of the requests [pool, 1]:
    each row the pool indices of one request's crops)."""
    rng = _rng(seed, 2)
    pool = int(traffic["pool"])
    crops = _images(rng, pool, pool, _hw(config))
    return crops, rng.permutation(pool).reshape(pool, 1)
