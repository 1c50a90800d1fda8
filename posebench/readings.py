"""The readings that a cell's limits are set from, in one process.

    python3 posebench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control 3] [--faults 3]

For each seed, the program's numbers (``judge``) as a run computes them:
a train cell's checked steps against the reference, a serving cell's
``checked_requests`` requests (served one at a time, as the window does)
against the reference.  ``--control N``: on the first N seeds, the
reference computed with float8 convolutions (``reference.model.Quantized``)
in the program's place.  ``--faults N``: on the first N seeds, the program
with a fault planted underneath its entry (``FAULTS``).  One JSON line a
reading; ``PERF.md`` gives the readings each limit was set from.  Runs on
the card; ``--device cpu`` with a test's small cell rehearses it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # run as a script: the checkout's root, not this folder, heads the path
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from posebench import harness, judge, traffic  # noqa: E402
from posebench.reference import model as ref_model  # noqa: E402


@contextlib.contextmanager
def half_batch_loss():
    """The train step's loss over the first half of the batch only."""
    from pytorch_pose_estimation_tpu_torch.train import steps

    saved = steps.sbp_loss, steps.spm_loss

    def halve(loss):
        return lambda logits, target: loss(
            logits[:len(logits) // 2], target[:len(target) // 2])

    steps.sbp_loss, steps.spm_loss = halve(saved[0]), halve(saved[1])
    try:
        yield
    finally:
        steps.sbp_loss, steps.spm_loss = saved


@contextlib.contextmanager
def frozen_update():
    """Every optimizer's update is zero: the step leaves the parameters
    and the optimizer's moments as they were."""
    from pytorch_pose_estimation_tpu_torch import optim

    saved = {cls: cls.__dict__["_update"]
             for cls in optim.ChainOptimizer.__subclasses__()}
    for cls in saved:
        cls._update = lambda self, p, g, state, group, count: \
            torch.zeros_like(p)
    try:
        yield
    finally:
        for cls, update in saved.items():
            cls._update = update


@contextlib.contextmanager
def shifted_answer():
    """The predictor's decode moves every map's first joint one cell to
    the right."""
    from pytorch_pose_estimation_tpu_torch.train import trainer

    saved = trainer.decode_sbp_fast

    def decode(logits, input_w, threshold, pred=True):
        out = saved(logits, input_w, threshold, pred).clone()
        out[:, 0, 0] += input_w / logits.shape[-1]
        return out

    trainer.decode_sbp_fast = decode
    try:
        yield
    finally:
        trainer.decode_sbp_fast = saved


@contextlib.contextmanager
def exchange_left_out():
    """The train step's gradient all-reduce returns each rank's own
    gradients and loss."""
    from pytorch_pose_estimation_tpu_torch.parallel import mesh

    saved = mesh.average_gradients
    mesh.average_gradients = lambda params, *values: values
    try:
        yield
    finally:
        mesh.average_gradients = saved


FAULTS = {"train": {"half_batch": half_batch_loss,
                    "unchanged_state": frozen_update},
          "infer": {"answer_altered": shifted_answer}}
# faults of the cells whose state or step spans several cards
MULTI_CHIP_FAULTS = {"train": {"exchange_left_out": exchange_left_out}}


def faults(cell):
    entry = cell.workload["entry"]
    return {**FAULTS[entry], **(MULTI_CHIP_FAULTS.get(entry, {})
                                if cell.chips > 1 else {})}


def faulty_rank_run(cell, t_start, fault):
    """A rank of a multi-card cell with ``fault`` planted in it."""
    from posebench.entries import train

    with (faults(cell)[fault]() if fault else contextlib.nullcontext()):
        return train.rank_run(cell, t_start)


def train_program(cell, device, fault=None):
    from posebench.entries import train

    if cell.chips > 1:
        short = dataclasses.replace(cell, seconds=0.0)
        first = train.ranks_run(short, 0.0, faulty_rank_run, fault)[0]
        return train.check(cell, first)
    with (faults(cell)[fault]() if fault else contextlib.nullcontext()):
        return _train_program(cell, device)


def _train_program(cell, device):
    from posebench.entries import train

    prog = train.Program(cell, device)
    readings = prog.checked_steps(int(cell.workload["checked_steps"]))
    arrays = prog.arrays
    prog.free()
    ref = train.reference(cell, arrays, device,
                          int(cell.workload["checked_steps"]))
    return with_leaves(readings, ref)


def train_control(cell, device):
    from posebench.entries import train

    arrays = traffic.cache_arrays(cell.traffic, cell.config, cell.seed)
    n = int(cell.workload["checked_steps"])
    ref = train.reference(cell, arrays, device, n)
    ctl = train.reference(cell, arrays, device, n, ref_model.Quantized)
    return with_leaves(ctl, ref)


def with_leaves(prog: dict, ref: dict) -> dict:
    """``judge.train_numbers`` and, for the look, each parameter's gap of
    the first gradient and of the change."""
    numbers = judge.train_numbers(prog, ref)
    numbers["grad_leaves"], numbers["update_leaves"] = judge.leaf_gaps(
        prog, ref)
    return numbers


def serve(cell, device):
    """The ``checked_requests`` first requests through the predictor:
    (pool, [(crop index, joints)])."""
    from posebench.entries import infer

    crops, order = traffic.request_pool(cell.traffic, cell.config, cell.seed)
    predict = infer.load_predictor(
        cell, infer.served_weights(cell, crops, device), device)
    n = int(cell.workload["checked_requests"])
    served = [(ids, predict(crops[ids]).cpu()) for ids in order[:n]]
    return crops, served


def infer_program(cell, device, fault=None):
    from posebench.entries import infer

    with (faults(cell)[fault]() if fault else contextlib.nullcontext()):
        crops, served = serve(cell, device)
        return infer.check(cell, crops, served, device)


def infer_control(cell, device):
    """The float8 reference's answers (argmax of the sigmoid, the
    threshold's sentinel) judged against the float32 reference."""
    from posebench.entries import infer

    cfg = cell.config
    crops, order = traffic.request_pool(cell.traffic, cfg, cell.seed)
    idx = order[:int(cell.workload["checked_requests"])].reshape(-1)
    ref = infer.reference_logits(cell, crops, idx, device)
    ctl = infer.reference_logits(cell, crops, idx, device,
                                 ref_model.Quantized)
    n, k, h, w = ctl.shape
    sig = 1.0 / (1.0 + np.exp(-ctl.reshape(n, k, h * w)))
    at = sig.argmax(-1)
    conf = np.take_along_axis(sig, at[..., None], -1)[..., 0]
    s = int(cfg["input_size"][1]) / w
    found = conf > float(cfg["conf_threshold"])
    joints = np.stack([np.where(found, (at % w) * s, -s),
                       np.where(found, (at // w) * s, -s),
                       np.where(found, conf, -1.0)], -1)
    return judge.infer_numbers(joints, ref, int(cfg["input_size"][1]),
                               float(cfg["conf_threshold"]))


SIDES = {"train": (train_program, train_control),
         "infer": (infer_program, infer_control)}


def readings(cell, seeds, n_control, n_faults, device, emit=print,
             program_side=True):
    entry = cell.workload["entry"]
    program, control = SIDES[entry]
    out = []

    def record(side, seed, numbers):
        row = {"workload": cell.name, "side": side, "seed": seed, **numbers}
        out.append(row)
        emit(json.dumps(row))

    for i, seed in enumerate(seeds):
        cell.seed = seed
        if program_side:
            record("program", seed, program(cell, device))
        if i < n_control:
            record("control", seed, control(cell, device))
        if i < n_faults:
            for name in faults(cell):
                record(name, seed, program(cell, device, name))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--program", action=argparse.BooleanOptionalAction,
                        default=True, help="read the program's side too "
                        "(--no-program: the control alone, on one card)")
    args = parser.parse_args(argv)
    harness.use_checkout_caches()
    cell = harness.load_cell(args.workload)
    t0 = time.perf_counter()
    readings(cell, args.seeds, args.control, args.faults,
             torch.device(args.device),
             emit=lambda s: print(s, flush=True), program_side=args.program)
    print(f"readings: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
