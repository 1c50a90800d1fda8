"""K3's train-mode BN + ReLU on the CPU: its plain PyTorch version
(``models/layers.py``, ``BnAct`` on a CPU tensor) against the unfused
chain of today's ``ConvBnAct`` / ``DeconvBnRelu`` train path, the ReLU
mask at y == 0, the dispatch between the two paths, and K3's tiling
(``ops/kernels.py``, ``bn_plan``) at the cells' 42 shapes.  The kernel
itself runs only on a card (``test_torch_port_bn_act_card.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_pose_estimation_tpu_torch import tracing
from pytorch_pose_estimation_tpu_torch.models import SBP, layers
from pytorch_pose_estimation_tpu_torch.models.layers import (
    BatchNorm2d, ConvBn, ConvBnRelu, DeconvBnRelu, bn_act,
    bn_act_backward_plain)
from pytorch_pose_estimation_tpu_torch.ops import kernels
from pytorch_pose_estimation_tpu_torch.parallel import mesh

from _bn_act_common import (assert_bf16_close, cell_shapes, reference,
                            rel, trunk_bn_shapes)

BF16 = torch.bfloat16

# (name, layer, input [N, C_in, H, W]): the stem's planes (SBP's 49,152 px,
# SPM's 262,144), layer5's 48 px (8x6), a deconvolution to 32x24 and an odd
# 7x5 plane; ConvBn has no activation
LAYERS = {
    "stem_sbp": (lambda: ConvBnRelu(3, 4, 3, dtype=BF16), (2, 3, 256, 192)),
    "stem_spm": (lambda: ConvBnRelu(3, 2, 3, dtype=BF16), (2, 3, 512, 512)),
    "layer5_relu": (lambda: ConvBnRelu(16, 64, 3, dtype=BF16), (4, 16, 8, 6)),
    "layer5_none": (lambda: ConvBn(16, 64, 1, dtype=BF16), (4, 16, 8, 6)),
    "deconv": (lambda: DeconvBnRelu(16, 16, dtype=BF16), (3, 16, 16, 12)),
    "odd_relu": (lambda: ConvBnRelu(8, 16, 3, dtype=BF16), (3, 8, 7, 5)),
    "odd_none": (lambda: ConvBn(8, 16, 3, dtype=BF16), (3, 8, 7, 5)),
}


def _bn(layer):
    return layer.bn if hasattr(layer, "bn") else layer[1]


def _activation(layer):
    return getattr(layer, "activation", F.relu)


def _conv(layer, inp):
    """The layer's convolution output in bf16, as its train path makes it."""
    if isinstance(layer, DeconvBnRelu):
        d = layer[0]
        return F.conv_transpose2d(inp.to(BF16), d.weight.to(BF16), None,
                                  d.stride, d.padding)
    c = layer.conv
    return F.conv2d(inp.to(BF16), c.weight.to(BF16), None, c.stride,
                    c.padding)


def _setup(name, seed=0):
    torch.manual_seed(seed)
    make, shape = LAYERS[name]
    layer = make().train()
    bn = _bn(layer)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0.0, 0.3)
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    inp = torch.randn(shape)
    return layer, inp


def _run(layer, x, dy, fused):
    """y, the gradients of x, weight and bias, and bn's buffers after one
    train-mode call on x, by the unfused chain or by ``bn_act``."""
    bn = _bn(layer)
    x = x.detach().clone().requires_grad_()
    act = _activation(layer)
    y = bn_act(x, bn, act is F.relu) if fused else \
        layers._block_out(x, bn, act, BF16)
    y.backward(dy)
    out = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad.clone(),
           "db": bn.bias.grad.clone(), "rm": bn.running_mean.clone(),
           "rv": bn.running_var.clone(),
           "nbt": int(bn.num_batches_tracked)}
    bn.weight.grad = bn.bias.grad = None
    return out


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_plain_matches_the_unfused_train_path(name):
    """The plain version (``bn_act`` on the CPU) against today's train
    path on the same bf16 convolution output: y and dx bit-equal in bf16
    or within one ulp, dweight and dbias within 1e-5 of the largest value,
    beside what fp32 ordering and a ReLU threshold on a bf16 value allow
    (``reference``); the running statistics by flax's rule (0.9 running +
    0.1 batch, biased variance) within 1e-6; one more batch tracked."""
    layer, inp = _setup(name)
    bn = _bn(layer)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    y_layer = layer(inp)  # today's path: the CPU takes the unfused chain
    with torch.no_grad():
        x = _conv(layer, inp)
    dy = torch.randn(x.shape).to(BF16)
    bn.load_state_dict(state)
    old = _run(layer, x, dy, fused=False)
    bn.load_state_dict(state)
    new = _run(layer, x, dy, fused=True)

    ref = reference(x, dy, bn.weight.detach(), bn.bias.detach(), bn.eps,
                    _activation(layer) is F.relu)
    eq = assert_bf16_close(new["y"], old["y"], ref["slack_y"])
    assert_bf16_close(new["y"], y_layer.detach(), ref["slack_y"])
    assert_bf16_close(new["dx"], old["dx"], ref["slack_dx"])
    assert rel(new["dw"], old["dw"], ref["flip_dw"]) <= 1e-5
    assert rel(new["db"], old["db"], ref["flip_db"]) <= 1e-5
    for k in ("rm", "rv"):
        assert rel(new[k], old[k]) <= 1e-6, k
    assert rel(new["rm"], 0.9 * 0.3 + 0.1 * ref["mean"]) <= 1e-6
    assert rel(new["rv"], 0.9 * 2.0 + 0.1 * ref["var"]) <= 1e-6
    assert new["nbt"] == old["nbt"] == 1
    print(f"{name}: y bit-equal {eq:.6f}")


@pytest.mark.parametrize("relu", [True, False])
def test_relu_mask_at_zero(relu):
    """Each channel holds 0, 1 and 2 in equal numbers and the bias is 0, so
    x * scale + shift is exactly 0 at x == 1: y is 0 there and the
    gradient stops there (and at x == 0) with the ReLU, as torch's
    threshold_backward stops it where the ReLU's output is not > 0; dbias
    is the sum of dy where it passes."""
    torch.manual_seed(1)
    x = torch.tensor([0.0, 1.0, 2.0]).repeat(2, 4, 3, 1).to(BF16)
    bn = BatchNorm2d(4).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.zero_()
    dy = torch.randn(x.shape).to(BF16)
    x = x.requires_grad_()
    y = bn_act(x, bn, relu)
    y.backward(dy)
    at = {v: x.detach() == v for v in (0.0, 1.0, 2.0)}
    assert bool((y[at[1.0]] == 0).all())
    assert bool((y[at[2.0]] > 0).all())
    passes = at[2.0] if relu else torch.ones_like(at[2.0])
    want = (dy.double() * passes).sum((0, 2, 3))
    assert rel(bn.bias.grad, want) <= 1e-6
    if relu:
        assert bool((y[at[0.0]] == 0).all())

    # the backward alone, with x * 1 + (-1) exactly 0 at x == 1
    stats = torch.stack([torch.zeros(4), torch.ones(4), torch.ones(4),
                         -torch.ones(4)])
    _, _, db = bn_act_backward_plain(dy, x.detach(), stats, relu)
    want = (dy.double() * (at[2.0] if relu else 1.0)).sum((0, 2, 3))
    assert rel(db, want) <= 1e-6


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device: the dispatch's view
    of a card's activation, without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fused_calls(monkeypatch):
    """``layers.bn_act`` replaced by a recorder of its calls, and the cross-
    replica BN by one that records and returns its input."""
    calls = []

    def fake_bn_act(x, bn, relu):
        calls.append(("bn_act", relu))
        return x

    def fake_cross(self, x):
        calls.append(("cross_replica", None))
        return x

    monkeypatch.setattr(layers, "bn_act", fake_bn_act)
    monkeypatch.setattr(BatchNorm2d, "_cross_replica", fake_cross)
    return calls


# case -> (on the card, train mode, compute dtype, activation, ranks, path)
DISPATCH = {
    "card_bf16_relu": (True, True, BF16, F.relu, 1, "fused"),
    "card_bf16_none": (True, True, BF16, None, 1, "fused"),
    "cpu": (False, True, BF16, F.relu, 1, "unfused"),
    "card_fp32": (True, True, torch.float32, F.relu, 1, "unfused"),
    "card_two_ranks": (True, True, BF16, F.relu, 2, "unfused"),
    "card_other_activation": (True, True, BF16, torch.tanh, 1, "unfused"),
    "card_eval": (True, False, BF16, F.relu, 1, "eval"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch(case, fused_calls, monkeypatch):
    """K3 only in train mode, on a CUDA tensor, in bf16, with ReLU or no
    activation, on one rank, counting ``bn.fused``; every other case takes
    the unfused chain, counting ``bn.unfused`` in train mode (eval: no
    count, torch's eval-mode BN)."""
    card, train, dtype, act, ranks, path = DISPATCH[case]
    monkeypatch.setattr(mesh, "world_size", lambda: ranks)
    bn = BatchNorm2d(3).train(train)
    x = torch.randn(2, 3, 4, 4).to(dtype)
    if card:
        x = x.as_subclass(_OnCard)
    with tracing.recording(device="cpu") as rec:
        y = layers._block_out(x, bn, act, dtype)
    counts = rec.summary()["counters"]
    assert y.dtype == dtype
    if path == "fused":
        assert fused_calls == [("bn_act", act is F.relu)]
        assert counts == {"bn.fused": 1}
    elif path == "unfused":
        assert counts == {"bn.unfused": 1}
        assert fused_calls == ([("cross_replica", None)] if ranks > 1
                               else [])
    else:
        assert counts == {} and fused_calls == []
        want = act(F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.1, bn.eps))
        torch.testing.assert_close(y.float(), want.to(dtype).float(),
                                   rtol=0, atol=0)


def test_sbp_train_step_counts_unfused_on_the_cpu():
    """A bf16 SBP forward in train mode on the CPU: all 21 BN layers take
    the unfused chain, none K3."""
    model = SBP(dtype=BF16).train()
    with tracing.recording(device="cpu") as rec:
        model(torch.randn(2, 3, 64, 48))
    assert rec.summary()["counters"] == {"bn.unfused": 21}


def test_shapes_are_the_models():
    """``trunk_bn_shapes`` lists, in order, the input shapes of the 21 BN
    layers an SBP forward reaches (64x48 input, hooks on the modules)."""
    model = SBP(dtype=torch.float32).eval()
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(
                lambda mod, args, out: seen.append(tuple(args[0].shape[1:])))
    with torch.no_grad():
        model(torch.randn(1, 3, 64, 48))
    assert seen == trunk_bn_shapes(64, 48)
    assert len(cell_shapes("sbp")) == len(cell_shapes("spm")) == 21


def _covered(plan):
    """How many times K3's threads visit each element of one image's row
    of c * hw, following ``place`` in csrc/bn_act.cu."""
    v = 8 if plan.vec else 1
    tiles = np.arange(-(-plan.c // plan.cpt) * plan.segs)
    group, seg = tiles // plan.segs, tiles % plan.segs
    e = np.arange(plan.threads) * v
    slot = e // plan.seg_len
    in_plane = seg[:, None] * plan.seg_len + e % plan.seg_len
    ch = group[:, None] * plan.cpt + slot
    active = (slot < plan.cpt) & (ch < plan.c) & (in_plane < plan.hw)
    first = (ch * plan.hw + in_plane)[active]
    row = np.zeros(plan.c * plan.hw, np.int64)
    for k in range(v):
        np.add.at(row, first + k, 1)
    return row


SHAPES = [(cell, i) for cell in ("sbp", "spm") for i in range(21)]
H100_SMS = 132  # the SMs of the card the cells run on (an H100 SXM)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("cell,i", SHAPES)
def test_tiling_covers_each_element_once(cell, i, vec):
    """At each of the cells' 42 BN shapes, vector and scalar path: every
    element of a row is some thread's exactly once, the image ranges cover
    the batch with none empty, a thread's V elements lie in one channel,
    and the grid fits the card's limits and fills an H100's SMs."""
    n, c, h, w = cell_shapes(cell)[i]
    plan = kernels.bn_plan(n, c, h * w, vec, H100_SMS)
    v = 8 if vec else 1
    assert bool((_covered(plan) == 1).all())
    assert plan.splits * plan.ipb >= n > (plan.splits - 1) * plan.ipb
    assert plan.seg_len % v == 0 and plan.hw % v == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.splits <= 65535
    blocks = -(-plan.c // plan.cpt) * plan.segs * plan.splits
    assert blocks >= H100_SMS  # every SM has a block


@pytest.mark.parametrize("shape", [(3, 5, 7, 5), (2, 1, 1, 2), (1, 3, 1, 9),
                                   (5, 1000, 8, 6), (4, 3, 45, 47),
                                   (64, 200, 2, 2)])
def test_tiling_covers_odd_shapes(shape):
    """Planes that are not a multiple of 8 (the scalar path), one channel,
    1x2 planes, the classifier's 1,000 channels at 8x6 and 200 at 2x2."""
    n, c, h, w = shape
    for vec in ((h * w) % 8 == 0, False):
        plan = kernels.bn_plan(n, c, h * w, vec, H100_SMS)
        assert bool((_covered(plan) == 1).all()), (shape, vec, plan)
        assert plan.splits * plan.ipb >= n > (plan.splits - 1) * plan.ipb
