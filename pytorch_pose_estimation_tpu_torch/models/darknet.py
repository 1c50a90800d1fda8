"""Darknet19, table-driven (reference: models/backbone/darknet.py:46-150).

Counterpart of pytorch_pose_estimation_tpu/models/darknet.py: a stem conv
plus five stages, each starting with a 2x2 max pool ('M') and alternating
3x3 / 1x1 convs; total stride 32.  Each stage is an ``nn.Sequential`` that
holds its max pools, so a conv sits at its table position.

Two forms, with the reference's state_dict keys for each:

* ``Darknet19``, the feature extractor (the JAX ``features_only=True``
  form), stages as children ``0`` .. ``5``: inside the pose models the keys
  are ``backbone_features_module.<stage>.<pos>.{conv,bn}.*``;
* ``Darknet19Classifier``, stages named ``stem``, ``layer1`` .. ``layer5``
  and the head ``classifier.0.{conv,bn}.*``: the reference's tiny-imagenet
  classifier layout, which the JAX package's
  ``models/torch_import.py:77-96`` reads.

The classifier head is dropout(0.5) -> 1x1 ConvBnRelu(num_classes) -> the
mean over H and W.  The dropout is flax's ``nn.Dropout(rate=0.5)``, as the
JAX package has it (``darknet.py:87``): it drops single elements, not whole
channels as the reference's Dropout2d did.  It is split into a sampler
(``sample_dropout_mask``, from a ``torch.Generator``) and a core
(``dropout_core``, which takes the keep mask), so that a test can feed the
port the mask JAX drew.  Under bf16 the head's ConvBnRelu returns bf16, so
the mean and the logits are bf16, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .layers import ConvBnRelu, max_pool_2x2

# Stage tables: 'M' = 2x2/2 max pool; (channels, kernel) = ConvBnRelu.
STEM = ((32, 3),)
LAYER1 = ("M", (64, 3))
LAYER2 = ("M", (128, 3), (64, 1), (128, 3))
LAYER3 = ("M", (256, 3), (128, 1), (256, 3))
LAYER4 = ("M", (512, 3), (256, 1), (512, 3), (256, 1), (512, 3))
LAYER5 = ("M", (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3))

STAGES = (STEM, LAYER1, LAYER2, LAYER3, LAYER4, LAYER5)
STAGE_NAMES = ("stem", "layer1", "layer2", "layer3", "layer4", "layer5")
OUT_CHANNELS = 1024
STRIDE = 32
DROPOUT_RATE = 0.5


def _stages(dtype: torch.dtype) -> List[nn.Sequential]:
    stages, c_in = [], 3
    for table in STAGES:
        mods = []
        for entry in table:
            if entry == "M":
                mods.append(max_pool_2x2())
            else:
                c_out, k = entry
                mods.append(ConvBnRelu(c_in, c_out, k, dtype=dtype))
                c_in = c_out
        stages.append(nn.Sequential(*mods))
    return stages


class Darknet19(nn.Module):
    """Darknet19 features.  Stages are children ``0`` .. ``5``.

    ``out_indices``: stage indices (0=stem .. 5=layer5) to return as a
    list; None returns only the final (layer5) map.
    """

    def __init__(self, out_indices: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices) if out_indices is not None \
            else None
        for i, stage in enumerate(_stages(dtype)):
            self.add_module(str(i), stage)

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        feats = []
        for stage in self.children():
            x = stage(x)
            feats.append(x)
        if self.out_indices is None:
            return feats[-1]
        return [feats[i] for i in self.out_indices]


def dropout_mask_shape(batch: int, height: int, width: int
                       ) -> Tuple[int, int, int, int]:
    """The shape of the classifier's dropout mask for a [batch, 3, height,
    width] input: that of layer5's output."""
    return (batch, OUT_CHANNELS, height // STRIDE, width // STRIDE)


def sample_dropout_mask(gen: Optional[torch.Generator], shape: Sequence[int],
                        rate: float = DROPOUT_RATE, device=None
                        ) -> torch.Tensor:
    """Keep mask: True with probability 1 - rate (uniform < 1 - rate, as
    ``jax.random.bernoulli``), drawn from ``gen``."""
    device = device if device is not None else (
        gen.device if gen is not None else None)
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return u < 1.0 - rate


def dropout_core(x: torch.Tensor, keep: torch.Tensor,
                 rate: float = DROPOUT_RATE) -> torch.Tensor:
    """flax ``nn.Dropout``: kept elements divided by 1 - rate, the rest 0,
    in the dtype of ``x``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class Darknet19Classifier(nn.Module):
    """Darknet19 with the classifier head, in the reference's classifier
    layout (``stem``, ``layer1`` .. ``layer5``, ``classifier.0``).

    ``forward(x, dropout_mask=None)`` -> logits [B, num_classes] in the
    model's dtype.  The dropout runs only when a keep mask is given (of
    ``dropout_mask_shape``; the train step samples it); without one, as in
    eval mode, the features pass unchanged."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = int(num_classes)
        for name, stage in zip(STAGE_NAMES, _stages(dtype)):
            self.add_module(name, stage)
        self.classifier = nn.Sequential(
            ConvBnRelu(OUT_CHANNELS, self.num_classes, 1, dtype=dtype))

    def forward(self, x: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for name in STAGE_NAMES:
            x = getattr(self, name)(x)
        if dropout_mask is not None:
            x = dropout_core(x, dropout_mask)
        x = self.classifier(x)
        return x.mean(dim=(2, 3))  # global average pool over H and W


def darknet19(pretrained: str = "", features_only: bool = False,
              out_indices: Optional[Sequence[int]] = None,
              num_classes: int = 1000, dtype: torch.dtype = torch.float32
              ) -> nn.Module:
    """Factory mirroring the reference's ``darknet19`` (reference:
    models/backbone/darknet.py:134-161): the features (``features_only``)
    or the classifier.  ``pretrained='tiny-imagenet'`` selects 200 classes;
    loading weights is a separate step (``Trainer``'s
    ``backbone_pretrained``, or ``load_state_dict``)."""
    if features_only:
        return Darknet19(out_indices, dtype)
    if pretrained == "tiny-imagenet":
        num_classes = 200
    return Darknet19Classifier(num_classes, dtype)
