"""Darknet19 backbone, table-driven (reference:
models/backbone/darknet.py:46-150).

Counterpart of pytorch_pose_estimation_tpu/models/darknet.py: a stem conv
plus five stages, each starting with a 2x2 max pool ('M') and alternating
3x3 / 1x1 convs; total stride 32.  Each stage is an ``nn.Sequential`` that
holds its max pools, so a conv sits at its table position and the
state_dict keys are the reference's ``<stage>.<pos>.{conv,bn}.*``.

This is the feature extractor (the JAX ``features_only=True`` form); the
classifier head comes with the classifier slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

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
        c_in = 3
        for i, table in enumerate(STAGES):
            mods = []
            for entry in table:
                if entry == "M":
                    mods.append(max_pool_2x2())
                else:
                    c_out, k = entry
                    mods.append(ConvBnRelu(c_in, c_out, k, dtype=dtype))
                    c_in = c_out
            self.add_module(str(i), nn.Sequential(*mods))

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        feats = []
        for stage in self.children():
            x = stage(x)
            feats.append(x)
        if self.out_indices is None:
            return feats[-1]
        return [feats[i] for i in self.out_indices]
