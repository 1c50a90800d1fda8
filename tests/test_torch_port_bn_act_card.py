"""K3 (``csrc/bn_act.cu``) on the card against its plain version, at every
one of the 42 BN shapes of the benchmark's two cells (SBP at batch 256,
SPM at 32), forward and backward; the variance against float64; the
scalar path; run-to-run bits; and a bf16 SBP train step that routes all
21 BN layers through K3.  Imports no JAX.  On the card::

    python3 -m pytest --noconftest -m card tests/test_torch_port_bn_act_card.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card host
lacks.)  Without a card every test here skips."""

import pytest
import torch
import torch.nn.functional as F

from pytorch_pose_estimation_tpu_torch import tracing
from pytorch_pose_estimation_tpu_torch.models import SBP
from pytorch_pose_estimation_tpu_torch.models.layers import (
    BatchNorm2d, _block_out, bn_act_backward_plain, bn_act_forward_plain)
from pytorch_pose_estimation_tpu_torch.ops import kernels

from _bn_act_common import assert_bf16_close, cell_shapes, reference, rel

BF16 = torch.bfloat16
EPS = 1e-5
pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, device, mean=0.5, std=2.0, seed=0, x=None):
    """x (bf16), dy (bf16), weight, bias, and fresh running statistics."""
    gen = torch.Generator(device).manual_seed(seed)
    c = shape[1]
    if x is None:
        x = (torch.randn(shape, generator=gen, device=device) * std
             + mean).to(BF16)
    dy = torch.randn(shape, generator=gen, device=device).to(BF16)
    weight = torch.rand(c, generator=gen, device=device) + 0.5
    bias = torch.randn(c, generator=gen, device=device) * 0.3
    return x, dy, weight, bias


def _buffers(c, device):
    return (torch.full((c,), 0.3, device=device),
            torch.full((c,), 2.0, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _both(x, dy, weight, bias, relu):
    """K3's and the plain version's forward and backward on the card."""
    out = {}
    for name, fwd, bwd in (
            ("k3", kernels.bn_act_forward_cuda, kernels.bn_act_backward_cuda),
            ("plain", bn_act_forward_plain, bn_act_backward_plain)):
        rm, rv, nbt = _buffers(x.shape[1], x.device)
        y, stats = fwd(x, weight, bias, rm, rv, nbt, 0.1, EPS, relu)
        dx, dw, db = bwd(dy, x, stats, relu)
        out[name] = {"y": y, "stats": stats, "rm": rm, "rv": rv,
                     "nbt": int(nbt), "dx": dx, "dw": dw, "db": db}
    return out["k3"], out["plain"]


def _check(k3, plain, ref):
    """``reference``'s allowances: one bf16 ulp and fp32 ordering, and
    where the ReLU's threshold falls on a bf16 value, that value's
    elements' masks."""
    assert_bf16_close(k3["y"], plain["y"], ref["slack_y"])
    assert_bf16_close(k3["dx"], plain["dx"], ref["slack_dx"])
    assert rel(k3["stats"][0], ref["mean"]) <= 1e-5
    assert rel(k3["stats"][1] ** -2 - EPS, ref["var"]) <= 2e-5
    for k in ("rm", "rv"):
        assert rel(k3[k], plain[k]) <= 1e-5, k
    for k in ("dw", "db"):
        assert rel(k3[k], plain[k], ref["flip_" + k]) <= 1e-5, k
        assert rel(k3[k], ref[k], ref["flip_" + k]) <= 1e-5, k
    assert k3["nbt"] == plain["nbt"] == 1


SHAPES = [(cell, i) for cell in ("sbp", "spm") for i in range(21)]


@pytest.mark.parametrize("cell,i", SHAPES)
def test_k3_matches_plain_at_the_cells_shapes(card, cell, i):
    """Forward and backward at each of the cells' 42 BN shapes (ReLU, as
    the trunk and the deconvolutions run them): y and dx bit-equal to the
    plain version's or within one bf16 ulp (fp32 ordering); the mean and
    variance within 1e-5 and 2e-5 of float64; the running statistics,
    dweight and dbias within 1e-5 of the plain version's, and the
    parameter gradients within 1e-5 of float64."""
    shape = cell_shapes(cell)[i]
    x, dy, weight, bias = _inputs(shape, card, seed=i)
    k3, plain = _both(x, dy, weight, bias, True)
    ref = reference(x, dy, weight, bias, EPS, True)
    _check(k3, plain, ref)


# (shape, relu, view at an odd offset): planes that are not a multiple of
# 8 and an input 2 bytes off a 16-byte boundary take the scalar path
SCALAR = {"7x5_relu": ((3, 16, 7, 5), True, False),
          "7x5_none": ((3, 16, 7, 5), False, False),
          "offset_relu": ((4, 64, 8, 6), True, True),
          "classifier_2x2": ((64, 200, 2, 2), True, False),
          "layer5_none": ((32, 512, 16, 16), False, False)}


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_k3_other_paths(card, name):
    """The scalar path and the path without the ReLU, against the plain
    version and float64 as above."""
    shape, relu, offset = SCALAR[name]
    x = None
    if offset:
        n = torch.Size(shape).numel()
        x = (torch.randn(n + 1, device=card) * 2).to(BF16)[1:].view(shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    x, dy, weight, bias = _inputs(shape, card, x=x)
    k3, plain = _both(x, dy, weight, bias, relu)
    _check(k3, plain, reference(x, dy, weight, bias, EPS, relu))


@pytest.mark.parametrize("shape", [(256, 1024, 8, 6), (256, 32, 256, 192),
                                   (32, 32, 512, 512), (256, 512, 16, 12)])
def test_k3_variance_is_near_float64(card, shape):
    """At mean 3, std 0.05 (test_torch_port_bn_variance.py's hard input),
    K3's batch variance, as the running variance after one update at
    momentum 1, within 2e-5 of the float64 variance of the bf16 values."""
    x = (torch.randn(shape, device=card) * 0.05 + 3.0).to(BF16)
    c = shape[1]
    rv = torch.zeros(c, device=card)
    kernels.bn_act_forward_cuda(
        x, torch.ones(c, device=card), torch.zeros(c, device=card),
        torch.zeros(c, device=card), rv,
        torch.zeros((), dtype=torch.int64, device=card), 1.0, EPS, True)
    exact = x.double().var((0, 2, 3), unbiased=False)
    err = float(((rv.double() - exact).abs() / exact).max())
    assert err <= 2e-5, err


def test_k3_gives_the_same_bits_every_run(card):
    """No atomics, a fixed order of merges: two runs, the same bits."""
    x, dy, weight, bias = _inputs((256, 64, 128, 96), card)
    runs = [_both(x, dy, weight, bias, True)[0] for _ in range(2)]
    for k in ("y", "stats", "rm", "rv", "dx", "dw", "db"):
        assert torch.equal(runs[0][k], runs[1][k]), k


@pytest.mark.parametrize("remat", [False, True])
def test_sbp_train_step_routes_every_bn_through_k3(card, remat):
    """A bf16 SBP forward and backward in train mode on the card: 21
    ``bn.fused`` and no ``bn.unfused``, one K3 forward and one backward
    launch a layer; with ``remat`` the backbone's 18 forwards run again in
    the backward and its BN buffers come back as the first pass left
    them."""
    model = SBP(dtype=BF16, remat=remat).to(card).train()
    img = torch.randn(4, 3, 256, 192, device=card)
    fwd0 = kernels.bn_act_forward_cuda.launches
    bwd0 = kernels.bn_act_backward_cuda.launches
    with tracing.recording() as rec:
        logits = model(img)
        bufs = [b.clone() for b in model.buffers()]
        logits.square().mean().backward()
    assert rec.summary()["counters"] == {"bn.fused": 21 + 18 * remat}
    assert kernels.bn_act_forward_cuda.launches - fwd0 == 21 + 18 * remat
    assert kernels.bn_act_backward_cuda.launches - bwd0 == 21
    for a, b in zip(bufs, model.buffers()):
        assert torch.equal(a, b)
    bn = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert all(int(m.num_batches_tracked) == 1 for m in bn)
    assert all(m.weight.grad is not None and
               bool(torch.isfinite(m.weight.grad).all()) for m in bn)


def test_layer_matches_the_unfused_chain_on_the_card(card):
    """A bf16 ConvBnRelu in train mode on the card (K3) against the
    unfused chain it replaced, run by hand on the same convolution
    output: y within one bf16 ulp, the gradients of x, weight and bias."""
    x, dy, weight, bias = _inputs((64, 128, 64, 48), card)
    out = {}
    for path in ("k3", "chain"):
        bn = BatchNorm2d(128).to(card).train()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xx = x.clone().requires_grad_()
        if path == "k3":
            y = _block_out(xx, bn, F.relu, BF16)
        else:
            y = F.relu(bn(xx.float())).to(BF16)
        y.backward(dy)
        out[path] = (y, xx.grad, bn.weight.grad, bn.bias.grad)
    ref = reference(x, dy, weight, bias, EPS, True)
    assert_bf16_close(out["k3"][0], out["chain"][0], ref["slack_y"])
    assert_bf16_close(out["k3"][1], out["chain"][1], ref["slack_dx"])
    assert rel(out["k3"][2], out["chain"][2]) <= 1e-5
    assert rel(out["k3"][3], out["chain"][3]) <= 1e-5
