"""The SBP and SPM pose network, the default of a configuration that names
no ``network``.

Published (myungsanglee/PyTorch-Pose-Estimation, models/backbone/darknet.py,
models/detector/sbp.py and spm.py): Darknet19's 18 conv -> BN -> ReLU
layers in six stages, five 2x2 max pools between them; three
ConvTranspose(4, 2, 1) of 512 channels, each -> BN -> ReLU; a 1x1 head of
K maps (SBP) or a root map and an x, y field a joint (SPM, 1 + 2K).
Output at a quarter of the input.

Departures: the weights are drawn from the seed (lecun-normal, BN scale 1,
BN shift the configuration's ``init.bn_shift``) where the source starts
from an ImageNet-trained backbone; nothing else.

The layer table and the counts are ``work.py``'s, the fp32 forward and the
weights ``reference/model.py``'s; this file puts them behind the interface
that every network file gives (``posebench/README.md``, "Adding a
network").
"""

from __future__ import annotations

from typing import Dict

from posebench import work
from posebench.reference import model

# configuration keys that the port's Trainer and predictor also need
port_keys = ()


def _shape(config: dict):
    """(kind, input height and width, keypoints)."""
    size = config["input_size"]
    hw = (size, size) if isinstance(size, int) else tuple(size)
    return config["kind"], hw, int(config["num_keypoints"])


def weights(config: dict, seed: int, device) -> Dict[str, object]:
    kind, _, k = _shape(config)
    return model.make_weights(kind, k, seed, device,
                              float(config["init"]["bn_shift"]))


def forward(p, x, config: dict, train: bool, quant=None, stats=None):
    kind, _, k = _shape(config)
    return model.forward(p, x, kind, k, train, quant, stats)


def groups(config: dict) -> Dict[str, str]:
    kind, _, k = _shape(config)
    return model.parameter_groups(kind, k)


def forward_flops(config: dict) -> int:
    return work.forward_flops(*_shape(config))


def train_flops(config: dict) -> int:
    return work.train_flops(*_shape(config))


def bn_act_elements(config: dict) -> int:
    """Every convolution's and deconvolution's output, which its BN + ReLU
    (K3 in the port) reads and writes; the head has none."""
    return sum(c_out * h_out * w_out for kind, _, _, c_out, _, _, _, h_out,
               w_out in work.layers(*_shape(config)) if kind != "head")
