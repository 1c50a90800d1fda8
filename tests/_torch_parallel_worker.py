"""Rank bodies of tests/test_torch_port_parallel.py.

``parallel.launch`` spawns the ranks (gloo, on the CPU) and runs
``rank_main(spec)`` in each; this module imports torch and the port only,
so a rank starts without JAX.  The one-process references run in the test
process through the same case functions, outside any process group.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pytorch_pose_estimation_tpu_torch import optim, parallel
from pytorch_pose_estimation_tpu_torch.data import (SBPCOCODataModule,
                                                    SPMCOCODataModule)
from pytorch_pose_estimation_tpu_torch.models import SBP, lecun_normal_
from pytorch_pose_estimation_tpu_torch.models.layers import (BatchNorm2d,
                                                             ConvBn,
                                                             ConvBnRelu)
from pytorch_pose_estimation_tpu_torch.train import (build_model,
                                                     make_sbp_steps,
                                                     make_spm_steps,
                                                     validate)
from pytorch_pose_estimation_tpu_torch.train import checkpoint
from pytorch_pose_estimation_tpu_torch.train import trainer as port_trainer
from pytorch_pose_estimation_tpu_torch.train_classifier import (
    build_classifier, make_classifier_steps)

HW, OUT, K, SIGMA = (64, 64), (16, 16), 17, 2.0
SGD = dict(lr=1e-2, momentum=0.9, weight_decay=5e-3, nesterov=True)
AUGMENT = {"clahe_prob": 0.5}  # the JAX defaults plus device CLAHE
CLASSES = 10


def bn_inputs(batch: int = 4):
    """x [B, 3, 5, 6] (mean 1, std 2), upstream gradient, weight, bias."""
    rng = np.random.RandomState(0)
    x = (rng.randn(batch, 3, 5, 6) * 2 + 1).astype(np.float32)
    g = rng.randn(batch, 3, 5, 6).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    return x, g, w, b


def bn_case(x, g, w, b) -> dict:
    """One train-mode BatchNorm2d forward of ``x`` and the backward of
    sum(y * g); returns y, the gradients and the running statistics."""
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.fill_(0.3)
        bn.running_var.fill_(2.0)
    x = torch.from_numpy(x).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def _state(model: nn.Module, opt) -> dict:
    """The model's state_dict and the optimizer's momentum traces, by
    parameter name, as CPU copies."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if "trace" in opt.state[p]:
            out["trace." + name] = opt.state[p]["trace"].detach().clone()
    return out


def same_on_all_ranks(tensors) -> bool:
    """Whether every rank holds bitwise rank 0's tensors."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(ref, flat))], dtype=torch.float64)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _finish(model, opt, losses, path) -> dict:
    """Losses, the state (written by rank 0 to ``path``, returned in one
    process) and whether the ranks agree bitwise."""
    state = _state(model, opt)
    if parallel.world_size() == 1:
        return {"losses": losses, "state": state}
    same = same_on_all_ranks(list(state.values()))
    if parallel.is_main():
        torch.save(state, path)
    return {"losses": losses, "same": same}


def sbp_case(model_path, batch, draws_list, out_path=None) -> dict:
    """SBP (full width, weights from ``model_path``) at 64x64: one train
    step per entry of ``draws_list`` (the global batch's draws) on this
    rank's rows of ``batch``, nesterov SGD at a constant lr."""
    model = SBP(K)
    model.load_state_dict(torch.load(model_path, weights_only=True))
    model.train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), **SGD)
    step, _ = make_sbp_steps(model, opt, list(HW), OUT, K, SIGMA, 0.25,
                             augment=AUGMENT)
    local = {k: torch.from_numpy(parallel.local_rows(v))
             for k, v in batch.items()}
    losses = [float(step(local, draws=d)) for d in draws_list]
    return _finish(model, opt, losses, out_path)


def spm_batch(batch: int = 4, size: int = 64, persons: int = 3):
    rng = np.random.RandomState(6)
    joints = rng.uniform(4, size - 4, (batch, persons, K, 2))
    return {"image": rng.randint(0, 256, (batch, size, size, 3),
                                 dtype=np.uint8),
            "joints": joints.astype(np.float32),
            "centers": joints.mean(2, keepdims=True).astype(np.float32)}


def spm_start() -> nn.Module:
    """The SPM case's seeded full-width model."""
    return build_model({"num_keypoints": K, "precision": "fp32", "seed": 3},
                       "spm")


def spm_case(batch, out_path=None) -> dict:
    """SPM (full width, seeded init) at 64x64: one train step with the
    photometric draws of the global batch from generators seeded alike."""
    model = spm_start().train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), **SGD)
    step, _ = make_spm_steps(model, opt, 64, 16, K, 1.0, 0.5,
                             augment={"clahe_prob": 0.5}, max_persons=3)
    gen, host_gen = (torch.Generator().manual_seed(5),
                     torch.Generator().manual_seed(5))
    local = {k: torch.from_numpy(parallel.local_rows(v))
             for k, v in batch.items()}
    losses = [float(step(local, gen, host_gen))]
    return _finish(model, opt, losses, out_path)


def classifier_batch(batch: int = 4):
    rng = np.random.RandomState(7)
    return (rng.randint(0, 256, (batch, 64, 64, 3), dtype=np.uint8),
            rng.randint(0, CLASSES, batch).astype(np.int64))


def classifier_start() -> nn.Module:
    """The classifier case's seeded model."""
    return build_classifier({"precision": "fp32", "seed": 4}, CLASSES)


def classifier_case(images, labels, out_path=None) -> dict:
    """The darknet19 classifier at 64x64: one train step, the dropout mask
    of the global batch drawn from a generator seeded alike."""
    model = classifier_start()
    opt = optim.get_optimizer("sgd", list(model.parameters()), **SGD)
    step, _ = make_classifier_steps(model, opt, CLASSES)
    gen = torch.Generator().manual_seed(8)
    x = torch.from_numpy(parallel.local_rows(images))
    y = torch.from_numpy(parallel.local_rows(labels))
    loss, acc = step(x, y, gen)
    losses = [float(loss), float(acc)]
    return _finish(model, opt, losses, out_path)


class TinyStride4(nn.Module):
    """The JAX tests' stride-4 stand-in for SBP (tests/test_parallel.py,
    tests/_mh_common.py) with the port's BatchNorm2d: flax's SAME padding
    of a stride-2 3x3 conv on an even size pads 0 before and 1 after, and
    flax's BatchNorm momentum 0.99 is torch's 0.01."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3, 2, bias=False)
        self.bn1 = BatchNorm2d(8)
        self.c2 = nn.Conv2d(8, 8, 3, 2, bias=False)
        self.bn2 = BatchNorm2d(8)
        self.head = nn.Conv2d(8, k, 1, bias=False)
        self.bn1.momentum = self.bn2.momentum = 0.01

    def forward(self, x):
        x = F.relu(self.bn1(self.c1(F.pad(x, (0, 1, 0, 1)))))
        x = F.relu(self.bn2(self.c2(F.pad(x, (0, 1, 0, 1)))))
        return self.head(x)


def tiny_case(state: dict, batch, draws_list, angle_groups: int,
              out_path=None) -> dict:
    """``TinyStride4`` from ``state`` at 32x32 (3 keypoints, sigma 1):
    one train step per entry of ``draws_list``, nesterov SGD at lr 1e-2
    (tests/_mh_common.py's step)."""
    model = TinyStride4()
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    model.train()
    opt = optim.get_optimizer("sgd", list(model.parameters()), **SGD)
    step, _ = make_sbp_steps(model, opt, [32, 32], (8, 8), 3, 1.0, 0.25,
                             augment={"angle_groups": angle_groups})
    local = {k: torch.from_numpy(parallel.local_rows(v))
             for k, v in batch.items()}
    losses = [float(step(local, draws=d)) for d in draws_list]
    return _finish(model, opt, losses, out_path)


class Tiny(nn.Module):
    """A stride-4 stand-in for the pose model with the port's BatchNorm:
    32x32 in, 8x8 maps out; seeded lecun init."""

    def __init__(self, k: int = K, seed: int = 0):
        super().__init__()
        self.net = nn.Sequential(ConvBnRelu(3, 8, 3, 2), ConvBnRelu(8, 8),
                                 ConvBn(8, 8, 3, 2))
        self.head = nn.Conv2d(8, k, 1, bias=False)
        lecun_normal_(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        return self.head(self.net(x))


def data_module(cfg: dict) -> SBPCOCODataModule:
    dm = SBPCOCODataModule(
        cfg["train_path"], cfg["val_path"], cfg["input_size"],
        cfg["output_size"], K, cfg["sigma"], 0, cfg["batch_size"],
        cfg["class_labels"], img_dir=cfg["img_dir"], use_native=False)
    dm.setup()
    return dm


def _validate(cfg: dict, dm, model: nn.Module, kind: str) -> tuple:
    """``validate`` on the CPU: (val_loss, val_mAP, the metric's
    predictions on rank 0, None elsewhere)."""
    metrics = []
    build = port_trainer.build_metric
    port_trainer.build_metric = lambda *a, **kw: (
        metrics.append(build(*a, **kw)), metrics[-1])[1]
    try:
        loss, ap = validate(cfg, dm, model, "cpu", verbose=False, kind=kind)
    finally:
        port_trainer.build_metric = build
    return loss, ap, metrics[0].result_list if metrics else None


def validate_case(cfg: dict, n_val: int) -> tuple:
    """``_validate`` of the seeded ``Tiny`` over the first ``n_val`` val
    instances."""
    dm = data_module(cfg)
    dm.val_db = dm.val_db[:n_val]
    return _validate(cfg, dm, Tiny(seed=1), "sbp")


def spm_validate_case(cfg: dict) -> tuple:
    """``_validate`` of the seeded full-width SPM (kind spm: the decoded
    roots and keypoints are a tuple) over the val images of ``cfg``."""
    dm = SPMCOCODataModule(None, cfg["val_path"], cfg["img_dir"],
                           cfg["input_size"], cfg["output_size"], K,
                           cfg["sigma"], 0, cfg["batch_size"],
                           cfg["class_labels"], max_persons=3,
                           use_native=False)
    dm.setup()
    model = build_model(dict(cfg, precision="fp32"), "spm")
    return _validate(cfg, dm, model, "spm")


def fit_case(cfg: dict) -> dict:
    """A cached ``Trainer.fit`` of ``Tiny`` (epochs and validation per
    ``cfg``), then a new Trainer resumed from 'auto' for one more epoch;
    returns the batches fed to each train step, the steps, this rank's
    checkpoint writes, the cache's shape and whether the ranks' final
    states agree bitwise."""
    port_trainer.build_model = lambda cfg, kind: Tiny()
    writes = []
    save = checkpoint._save_atomic
    checkpoint._save_atomic = lambda obj, path: (writes.append(path),
                                                 save(obj, path))
    fed = []

    def record(trainer):
        step = trainer.train_step

        def wrapped(batch, *args, **kwargs):
            fed.append({k: v.clone().numpy() for k, v in batch.items()})
            return step(batch, *args, **kwargs)
        trainer.train_step = wrapped

    dm = data_module(cfg)
    first = port_trainer.Trainer(cfg, dm, device="cpu")
    record(first)
    first.fit()
    n_first = len(fed)
    cache = first._device_cache
    again = port_trainer.Trainer(dict(cfg, epochs=cfg["epochs"] + 1), dm,
                                 device="cpu")
    record(again)
    again.fit(resume="auto")
    state = _state(again.model, again.state.optimizer)
    return {"fed": fed[:n_first], "fed_resumed": fed[n_first:],
            "steps": (first.state.step, again.state.step),
            "writes": len(writes), "nbytes": cache.nbytes(),
            "n_total": cache.n_total, "n_local": cache.n_local,
            "same": same_on_all_ranks(list(state.values()))}


def fail_on_rank_1() -> None:
    if parallel.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    parallel.barrier()  # waits for rank 1, which never comes


def bn_main(cases: dict) -> dict:
    """``bn_case`` of each named (x, g, w, b) on this rank's rows of the
    batch (tests/test_torch_port_bn_variance.py)."""
    return {"world": parallel.world_size(),
            **{name: bn_case(*(parallel.local_rows(a) if a.ndim == 4 else a
                               for a in args))
               for name, args in cases.items()}}


def rank_main(spec: dict) -> dict:
    """Every case of ``spec`` on this rank, in one group."""
    os.chdir(spec["cwd"])  # the metric writes results.json to the cwd
    r = parallel.rank()
    out = {"rank": r, "world": parallel.world_size(),
           "bn": bn_case(*(parallel.local_rows(a) if a.ndim == 4 else a
                           for a in spec["bn"]))}
    if "sbp" in spec:
        for name, (draws, groups) in spec["tiny"]["draws"].items():
            out["tiny_" + name] = tiny_case(
                spec["tiny"]["state"], spec["tiny"]["batch"], draws, groups,
                os.path.join(spec["cwd"], f"tiny_{name}.pt"))
        for name, draws in spec["sbp"]["draws"].items():
            out["sbp_" + name] = sbp_case(
                spec["sbp"]["model"], spec["sbp"]["batch"], draws,
                os.path.join(spec["cwd"], f"sbp_{name}.pt"))
        out["spm"] = spm_case(spec["spm"],
                              os.path.join(spec["cwd"], "spm.pt"))
        out["classifier"] = classifier_case(
            *spec["classifier"], os.path.join(spec["cwd"], "classifier.pt"))
        out["validate"] = validate_case(*spec["validate"])
        out["spm_validate"] = spm_validate_case(spec["spm_validate"])
        out["fit"] = fit_case(spec["fit"])
    return out
