"""Height-sharded inference across GPUs: each rank holds a block of the
image's rows, and the rows that a convolution needs from a neighbour move
explicitly.

Counterpart of pytorch_pose_estimation_tpu/parallel/mesh.py's
``spatial_sharding``, which splits the image height (NHWC dim 1) over the
mesh and lets GSPMD insert the convolutions' halo exchanges: "the scaling
axis for large-input (SPM 512^2+) or batch-1 inference across a slice".
Here the height is NCHW dim 2, split over the ranks of the default process
group (``mesh.launch`` or torchrun) in rank order:

* ``spatial_rows(x)``: this rank's block of rows of a batch;
* ``spatial_forward(model, rows)``: the eval forward of a ``PoseNet`` (SBP
  or SPM) or of an ``nn.Sequential`` of the port's layers on those rows:
  this rank's rows of the output;
* ``gather_spatial(t)``: every rank's rows along dim 2, on every rank.

Each layer's halo comes from the layer itself: a stride-1 convolution
with kernel k and padding p needs p rows from the rank above and k-1-p
from the rank below (a 3x3 ``ConvBnAct``: one each; a 1x1 conv and the
head: none); a transposed convolution (kernel k, stride s, padding p)
needs (k-1-p)//s rows above and (p+s-1)//s below (``DeconvBnRelu``: one
each), runs on the extended rows and keeps the output rows of its own
block; a max pool whose kernel equals its stride needs none, as long as
every block's rows divide by the stride, which the height check ensures.
At the image's top and bottom the missing rows are zeros, as the
convolutions' padding is.  In eval mode BatchNorm works per pixel.  The
rows move in the convolution's input dtype, after the cast that the
layer's own forward makes, so a bf16 model exchanges bf16 rows.  The
layers' numerics are their own: ``ConvBnAct.padded``,
``DeconvBnRelu.cropped`` and ``PoseNet.logits``, which their ``forward``
methods call too; with one rank ``spatial_forward`` is ``model(rows)``.

Every exchange is one all-reduce of a zero-filled int32 buffer in which
each rank writes the bytes of its own edge rows (its first rows for the
rank above, its last for the rank below): each byte is nonzero on one rank
at most, so the integer sum carries no bits and every rank reads its
neighbours' rows bit for bit, in any dtype.  An all-reduce is the one
collective that both backends run on CPU and CUDA tensors (gloo has no
point-to-point or all-gather on the GPU): gloo on the CPU and for ranks
sharing one card, NCCL where each rank owns a card.  ``gather_spatial``
is ``mesh.gather_rows`` along dim 2.  A PoseNet
forward makes 15 exchanges (12 3x3 convs and 3 deconvs).  cuDNN picks its
algorithms by shape, so a block's output is not bitwise the one-process
output's rows.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh


def spatial_rows(x: torch.Tensor, r: Optional[int] = None,
                 world: Optional[int] = None) -> torch.Tensor:
    """Rows ``r*h:(r+1)*h`` of the height (dim 2) of an NCHW batch whose
    height is ``world * h``; raises unless ``world`` divides it."""
    world = mesh.world_size() if world is None else world
    if x.shape[2] % world:
        raise ValueError(f"height {x.shape[2]} is not divisible by the "
                         f"{world} ranks")
    return mesh.local_rows(x.movedim(2, 0), r, world).movedim(0, 2)


def _zero_buffer(shape, dtype, device):
    """(int32 words, a ``dtype`` view of ``shape`` over their bytes), all
    zero."""
    n_bytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    words = torch.zeros(-(-n_bytes // 4), dtype=torch.int32, device=device)
    return words, words.view(torch.uint8)[:n_bytes].view(dtype).view(shape)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_reduce_bits(words: torch.Tensor, stats: Optional[dict]) -> None:
    if stats is None:
        dist.all_reduce(words)
        return
    _sync(words.device)
    t0 = time.perf_counter()
    dist.all_reduce(words)
    _sync(words.device)
    stats["exchange_s"] = stats.get("exchange_s", 0.0) + \
        time.perf_counter() - t0


def gather_spatial(t: torch.Tensor) -> torch.Tensor:
    """The rows of every rank's ``t`` (all of one shape) along dim 2, in
    rank order, on every rank (``mesh.gather_rows``: adding zeros is
    exact)."""
    if mesh.world_size() == 1:
        return t
    return mesh.gather_rows(t.movedim(2, 0)).movedim(0, 2).contiguous()


def _halo(x: torch.Tensor, above: int, below: int,
          stats: Optional[dict]) -> torch.Tensor:
    """``x``'s rows with ``above`` rows of the rank above on top and
    ``below`` rows of the rank below under them (zeros at the image's
    edges)."""
    if not (above or below):
        return x
    world, r = mesh.world_size(), mesh.rank()
    b, c, h, w = x.shape
    if max(above, below) > h:
        raise ValueError(f"a block of {h} rows cannot lend {max(above, below)}"
                         f" rows to a neighbour")
    words, buf = _zero_buffer((world, b, c, below + above, w), x.dtype,
                              x.device)
    buf[r, :, :, :below] = x[:, :, :below]  # for the rank above
    buf[r, :, :, below:] = x[:, :, h - above:]  # for the rank below
    _all_reduce_bits(words, stats)
    top = buf[r - 1, :, :, below:] if r > 0 else x.new_zeros(b, c, above, w)
    bottom = buf[r + 1, :, :, :below] if r < world - 1 else \
        x.new_zeros(b, c, below, w)
    if stats is not None:
        stats["exchanges"] = stats.get("exchanges", 0) + 1
        per_row = b * c * w * x.element_size()
        stats["halo_bytes"] = stats.get("halo_bytes", 0) + \
            per_row * (above + below)
    return torch.cat([top, x, bottom], 2)


def _conv_halo(conv: nn.Conv2d, x: torch.Tensor,
               stats: Optional[dict]) -> torch.Tensor:
    """``x``, this rank's rows of a stride-1 convolution's input, with the
    halo that the convolution needs."""
    (k, _), p = conv.kernel_size, conv.padding[0]
    if conv.stride[0] != 1 or conv.dilation != (1, 1) or conv.groups != 1:
        raise ValueError(f"spatial_forward splits stride-1 convolutions "
                         f"only, got {conv}")
    return _halo(x, p, k - 1 - p, stats)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stats) -> torch.Tensor:
    """An ``nn.Conv2d`` on this rank's rows."""
    return F.conv2d(_conv_halo(conv, x, stats), conv.weight, conv.bias,
                    conv.stride, (0, conv.padding[1]))


def _conv_bn_act(layer, x: torch.Tensor, stats) -> torch.Tensor:
    """``ConvBnAct`` on this rank's rows."""
    x = _conv_halo(layer.conv, x.to(layer.dtype), stats)
    return layer.padded(x, (0, layer.conv.padding[1]))


def _deconv_bn_relu(layer, x: torch.Tensor, stats) -> torch.Tensor:
    """``DeconvBnRelu`` on this rank's rows: the transposed convolution on
    the rows extended by its halo, cropped to this block's output rows."""
    deconv = layer[0]
    (k, _), (s, _), (p, _) = deconv.kernel_size, deconv.stride, \
        deconv.padding
    if deconv.output_padding != (0, 0) or deconv.dilation != (1, 1) or \
            deconv.groups != 1:
        raise ValueError(f"spatial_forward cannot split {deconv}")
    h = x.shape[2]
    above = (k - 1 - p) // s
    x = _halo(x.to(layer.dtype), above, (p + s - 1) // s, stats)
    return layer.cropped(x, slice(s * above, s * above + s * h))


def _pool(layer: nn.MaxPool2d, x: torch.Tensor) -> torch.Tensor:
    k, s = layer.kernel_size, layer.stride
    k = k if isinstance(k, int) else k[0]
    s = s if isinstance(s, int) else s[0]
    if k != s or layer.padding not in (0, (0, 0)) or layer.ceil_mode:
        raise ValueError(f"spatial_forward splits pools whose kernel is "
                         f"their stride only, got {layer}")
    return layer(x)


def _run(module: nn.Module, x: torch.Tensor, stats) -> torch.Tensor:
    from ..models.layers import ConvBnAct, DeconvBnRelu

    if isinstance(module, ConvBnAct):
        return _conv_bn_act(module, x, stats)
    if isinstance(module, DeconvBnRelu):
        return _deconv_bn_relu(module, x, stats)
    if isinstance(module, nn.Sequential):
        for child in module:
            x = _run(child, x, stats)
        return x
    if isinstance(module, nn.MaxPool2d):
        return _pool(module, x)
    if isinstance(module, nn.Conv2d):
        return _conv(module, x, stats)
    raise ValueError(f"spatial_forward cannot split the rows of "
                     f"{type(module).__name__}")


def _row_multiple(model: nn.Module) -> int:
    """What every rank's rows must divide by: the PoseNet's stride, or the
    product of a Sequential's pool strides."""
    from ..models.darknet import STRIDE
    from ..models.sbp import PoseNet

    if isinstance(model, PoseNet):
        return STRIDE
    n = 1
    for m in model.modules():
        if isinstance(m, nn.MaxPool2d):
            s = m.stride if isinstance(m.stride, int) else m.stride[0]
            n *= s
    return n


def spatial_forward(model: nn.Module, rows: torch.Tensor,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """The eval forward of ``model`` (a ``PoseNet`` or an ``nn.Sequential``
    of the port's layers) on this rank's block of rows of an NCHW batch
    (``spatial_rows``): this rank's rows of the output (a PoseNet's logits
    in fp32).  ``stats``, a dict, collects ``exchanges``, ``halo_bytes``
    (what this rank sends, summed over the exchanges) and ``exchange_s``
    (host clock, the device synchronized around each exchange).  Raises a
    ValueError on a model in train mode and where the rows of a block do
    not divide by the stride that the model needs (32 for a PoseNet:
    the global height by world x 32)."""
    from ..models.sbp import PoseNet

    if any(m.training for m in model.modules()):
        raise ValueError("spatial_forward serves inference: put the model "
                         "in eval mode")
    if not isinstance(model, (PoseNet, nn.Sequential)):
        raise ValueError(f"spatial_forward takes a PoseNet or an "
                         f"nn.Sequential, got {type(model).__name__}")
    world, h, n = mesh.world_size(), rows.shape[2], _row_multiple(model)
    if h % n:
        raise ValueError(f"height {h * world} is not a multiple of "
                         f"{world} ranks x {n}")
    if world == 1:
        return model(rows)
    if not isinstance(model, PoseNet):
        return _run(model, rows, stats)
    x = rows
    for stage in model.backbone_features_module.children():
        x = _run(stage, x, stats)
    for deconv in (model.deconv_1, model.deconv_2, model.deconv_3):
        x = _deconv_bn_relu(deconv, x, stats)
    return model.logits(x)  # a 1x1 convolution: no halo
