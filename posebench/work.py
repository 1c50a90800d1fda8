"""The yardstick's arithmetic: the work a cell asks for, from its shapes.

The counts follow the model's published layout (Darknet19 features, three
4x4 stride-2 deconvolutions of 512 channels, a 1x1 head), whatever kernels
compute it, so a later change to a kernel or a layer is judged against the
same work.  FLOPs count multiply-adds as two, convolutions only, as
``torch.utils.flop_counter`` counts them; the backward pass costs two
forwards (input and weight gradients) except the first layer's input
gradient, which nothing needs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Darknet19 (models/backbone/darknet.py of the reference): 'M' is a 2x2
# stride-2 max pool, (channels, kernel) a conv -> BN -> ReLU
STAGES = (((32, 3),),
          ("M", (64, 3)),
          ("M", (128, 3), (64, 1), (128, 3)),
          ("M", (256, 3), (128, 1), (256, 3)),
          ("M", (512, 3), (256, 1), (512, 3), (256, 1), (512, 3)),
          ("M", (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)))
DECONVS = 3
DECONV_CHANNELS = 512

# (kind, key prefix, c_in, c_out, kernel, h_in, w_in, h_out, w_out)
Layer = Tuple[str, str, int, int, int, int, int, int, int]


def head_channels(kind: str, num_keypoints: int) -> int:
    """SBP: one map per keypoint; SPM: a root map and an x, y field per
    keypoint."""
    return num_keypoints if kind == "sbp" else 1 + 2 * num_keypoints


def layers(kind: str, in_hw: Sequence[int], num_keypoints: int
           ) -> List[Layer]:
    """Every convolution of the pose network at input ``in_hw``, in order,
    under the reference's state_dict key prefixes."""
    h, w = int(in_hw[0]), int(in_hw[1])
    out, c = [], 3
    for s, table in enumerate(STAGES):
        for pos, entry in enumerate(table):
            if entry == "M":
                h, w = h // 2, w // 2
                continue
            c_out, k = entry
            out.append(("conv", f"backbone_features_module.{s}.{pos}", c,
                        c_out, k, h, w, h, w))
            c = c_out
    for i in range(1, DECONVS + 1):
        out.append(("deconv", f"deconv_{i}", c, DECONV_CHANNELS, 4, h, w,
                    2 * h, 2 * w))
        c, h, w = DECONV_CHANNELS, 2 * h, 2 * w
    out.append(("head", f"{kind}_head.0", c,
                head_channels(kind, num_keypoints), 1, h, w, h, w))
    return out


def layer_flops(layer: Layer) -> int:
    """One image's forward FLOPs of one layer: a convolution multiplies
    every output pixel by its k x k x c_in taps; a transposed one scatters
    every input pixel through them."""
    kind, _, c_in, c_out, k, h_in, w_in, h_out, w_out = layer
    pixels = h_in * w_in if kind == "deconv" else h_out * w_out
    return 2 * c_in * c_out * k * k * pixels


def forward_flops(kind: str, in_hw: Sequence[int], num_keypoints: int
                  ) -> int:
    """One image's forward FLOPs."""
    return sum(layer_flops(l) for l in layers(kind, in_hw, num_keypoints))


def train_flops(kind: str, in_hw: Sequence[int], num_keypoints: int) -> int:
    """One image's forward and backward FLOPs."""
    ls = layers(kind, in_hw, num_keypoints)
    return 3 * sum(layer_flops(l) for l in ls) - layer_flops(ls[0])


def parameter_count(kind: str, num_keypoints: int) -> int:
    """Convolution weights plus each BN's scale and bias."""
    n = 0
    for kind_, _, c_in, c_out, k, *_ in layers(kind, (32, 32), num_keypoints):
        n += c_in * c_out * k * k + (0 if kind_ == "head" else 2 * c_out)
    return n


def sbp_heatmap_bytes(b: int, k: int, h: int, w: int) -> int:
    """K1: the joints read once ([B, K, 2] fp32), the maps written once
    ([B, K, h, w] fp32)."""
    return b * k * 2 * 4 + b * k * h * w * 4


def sbp_decode_bytes(b: int, k: int, h: int, w: int) -> int:
    """K2: the logits read once ([B, K, h, w] fp32), the joints written
    once ([B, K, 3] fp32)."""
    return b * k * h * w * 4 + b * k * 3 * 4


def bn_act_bytes(elements: int) -> int:
    """K3 (csrc/bn_act.cu), a train step over ``elements`` activation
    elements of BN + ReLU layers, bf16, 16 B an element: forward, the
    input read for the batch statistics and again to apply them, the
    output written (6 B); backward, the output's gradient and the input
    read for the gradient's sums and again to apply them, the input's
    gradient written (10 B).  Batch statistics come before any output,
    so a layer's tensors are read in two passes."""
    return 16 * elements


def roofline_percent(n_bytes: int, seconds_per_call: float) -> float:
    """Share of a memory-bound kernel's least time (its bytes at the HBM
    rate) in its measured time."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds_per_call


def mfu_percent(flops_per_item: float, items_per_s: float,
                chips: int = 1) -> float:
    """Model FLOPs per second over the chips' bf16 peak."""
    return 100.0 * flops_per_item * items_per_s / (PEAK_BF16_FLOPS * chips)
