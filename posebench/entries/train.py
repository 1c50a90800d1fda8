"""Train cells: a closed loop of ``Trainer.train_step`` fed by
``DeviceDataCache.epoch_batches``, as ``Trainer.fit``'s cached loop runs
it, with no host sync a step.

Set-up makes the cache's arrays and the weights from the seed, builds the
Trainer (``cache_device`` on: CLAHE runs on the device), loads the
weights, resumes the optimizer at ``start_step`` of the workload (past the
schedule's burn-in, where the learning rate is the configured one) and
drives the first ``checked_steps`` steps through the window's own call and
feed.  Those are the steps the reference follows.  The window then runs
steps for the given seconds and ends in a synchronize; the images of every
step over the window's time are ``train_images_per_s``.

With ``trace`` the window also records CUDA events at the feed's edges and
at the step's ``marker`` boundaries, and after it a few steps run under
the profiler.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from posebench import harness, judge, trace, traffic, work
from posebench.reference import train as ref_train

# the port's Trainer keys that a configuration file carries
PORT_KEYS = ("num_keypoints", "precision", "input_size", "output_size",
             "sigma", "conf_threshold", "batch_size", "optimizer",
             "optimizer_options", "scheduler", "scheduler_options",
             "max_persons")
TRACE_PATH = harness.ROOT / "build" / "posebench" / "trace.json"


def port_config(config: dict, net) -> dict:
    """The Trainer's configuration: the file's sizes, precision,
    optimizer and augmentation, and the keys that the network ``net``
    adds (``port_keys``), the device cache on."""
    keys = PORT_KEYS + tuple(net.port_keys)
    cfg = {k: config[k] for k in keys if k in config}
    cfg.update(seed=0, remat=False, cache_device=True,
               augment_options=dict(config["augment"]))
    return cfg


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test, set up for one cell and seed."""

    def __init__(self, cell: harness.Cell, device: torch.device):
        from pytorch_pose_estimation_tpu_torch.parallel import mesh
        from pytorch_pose_estimation_tpu_torch.train import (
            DeviceDataCache, Trainer)

        cfg, seed = cell.config, cell.seed
        ref_train.rules(cfg)   # a rule the reference lacks fails here
        self.device = device
        self.kind = cfg["kind"]
        clock = harness.Stopwatch()
        self.arrays = traffic.cache_arrays(cell.traffic, cfg, seed)
        clock.lap("arrays")
        self.weights = harness.cell_weights(cell, device)
        self.trainer = Trainer(port_config(cfg, cell.net), None,
                               kind=self.kind, logging=False, device=device)
        self.trainer.model.load_state_dict(self.weights)
        opt = self.trainer.state.optimizer
        state = opt.state_dict()
        state["count"] = int(cell.workload["start_step"])
        opt.load_state_dict(state)
        clock.lap("trainer")
        self.cache = DeviceDataCache(self.arrays, int(cfg["batch_size"]),
                                     seed=seed, device=device,
                                     rank=mesh.rank(),
                                     world=mesh.world_size())
        clock.lap("cache")
        clock.report("set-up")
        self.gen_seed = harness.torch_seed(seed, 4)
        self.gen = torch.Generator(device).manual_seed(self.gen_seed)
        self.host_gen = torch.Generator().manual_seed(self.gen_seed)
        self.batches = self._epochs()

    def _epochs(self):
        epoch = 0
        while True:
            yield from self.cache.epoch_batches(epoch)
            epoch += 1

    def step(self) -> torch.Tensor:
        return self.trainer.train_step(next(self.batches), self.gen,
                                       self.host_gen)

    def checked_steps(self, n: int) -> dict:
        """``n`` steps; the losses, each parameter's first gradient norm
        (``.grad`` as the optimizer read it) and its change's norm, and the
        first step's logits (this rank's rows)."""
        model = self.trainer.model
        params = dict(model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in params.items()}
        logits = []
        hook = model.register_forward_hook(
            lambda module, args, out: logits.append(out.detach().cpu()))
        losses, first = [], None
        for i in range(n):
            losses.append(self.step())
            if i == 0:
                hook.remove()
                first = {k: p.grad.norm() for k, p in params.items()}
        change = {k: (p.detach() - p0[k]).norm() for k, p in params.items()}
        return {"losses": [float(x) for x in losses],
                "grad_norms": {k: float(v) for k, v in first.items()},
                "change_norms": {k: float(v) for k, v in change.items()},
                "logits": logits[0]}

    def window(self, seconds: float, events: bool = False,
               n_steps: Optional[int] = None):
        """Steps for ``seconds``, or ``n_steps`` of them: (steps, seconds
        taken, losses, per-step CUDA events)."""
        spans: List[Dict[str, torch.cuda.Event]] = []

        def event(marks, name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks[name] = e

        sync(self.device)
        t0 = time.perf_counter()
        losses = []
        while (len(losses) < n_steps if n_steps is not None
               else time.perf_counter() - t0 < seconds):
            if events:
                marks: Dict[str, torch.cuda.Event] = {}
                event(marks, "begin")
                batch = next(self.batches)
                event(marks, "fed")
                losses.append(self.trainer.train_step(
                    batch, self.gen, self.host_gen,
                    marker=lambda name, m=marks: event(m, name)))
                spans.append(marks)
            else:
                losses.append(self.step())
        sync(self.device)
        return len(losses), time.perf_counter() - t0, losses, spans

    def traced_steps(self, n: int) -> dict:
        from torch.profiler import record_function

        def steps():
            for _ in range(n):
                with record_function("feed"):
                    batch = next(self.batches)
                with record_function("train_step"):
                    self.trainer.train_step(batch, self.gen, self.host_gen)

        from pytorch_pose_estimation_tpu_torch.parallel import mesh

        return trace.profile(steps, TRACE_PATH.with_suffix(
            f".{mesh.rank()}.json"))

    def free(self) -> None:
        del self.trainer, self.cache, self.batches
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def event_means(spans) -> Dict[str, float]:
    """Mean ms a step of each part between the recorded boundaries."""
    parts = {"gather": ("begin", "fed"), "augment": ("fed", "augment"),
             "fwd_bwd": ("targets", "forward_backward"),
             "all_reduce": ("forward_backward", "all_reduce")}
    out = {}
    for name, (a, b) in parts.items():
        times = [s[a].elapsed_time(s[b]) for s in spans if a in s and b in s]
        if times:
            out[name] = sum(times) / len(times)
    opt = [s["all_reduce" if "all_reduce" in s else "forward_backward"]
           .elapsed_time(s["optimizer"]) for s in spans]
    if opt:
        out["optimizer"] = sum(opt) / len(opt)
    return out


def reference(cell: harness.Cell, arrays: dict, device: torch.device,
              n: int, quant=None) -> dict:
    """The reference's readings of the first ``n`` steps of the cell."""
    cfg = cell.config
    b = int(cfg["batch_size"])
    rows = ref_train.cache_rows(len(arrays["image"]), cell.seed, b, n,
                                cell.chips)
    batches = [{k: torch.from_numpy(v[r]).to(device)
                for k, v in arrays.items()} for r in rows]
    weights = harness.cell_weights(cell, device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return ref_train.run_steps(cfg, cell.net, weights, batches,
                                   harness.torch_seed(cell.seed, 4),
                                   int(cell.workload["start_step"]), quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def rank_run(cell: harness.Cell, t_start: float) -> dict:
    """Set-up, the checked steps, the window and (with ``trace``) the
    profiled steps on this process's card (one rank of several, or the
    only one).  With several ranks the window runs a step count that rank
    0 fixes from the set-up's rate, so that every rank runs as many
    collectives.  Returns what the result needs, on the host."""
    device = torch.device(cell.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg, wl = cell.config, cell.workload
    from pytorch_pose_estimation_tpu_torch.parallel import mesh

    world, main = mesh.world_size(), mesh.is_main()
    prog = Program(cell, device)
    clock = harness.Stopwatch()
    readings = prog.checked_steps(int(wl["checked_steps"]))
    clock.lap("checked steps")
    n_steps = None
    if world > 1:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(int(wl["rate_steps"])):
            prog.step()
        sync(device)
        rate = int(wl["rate_steps"]) / (time.perf_counter() - t0)
        n_steps = mesh.broadcast_object(max(1, round(cell.seconds * rate)))
        mesh.barrier()
        clock.lap("rate steps")
    if main:
        clock.report("set-up")
    setup_s = time.perf_counter() - t_start
    steps, seconds, losses, spans = prog.window(cell.seconds, cell.trace,
                                                n_steps)
    out = {"setup_s": setup_s, "steps": steps, "seconds": seconds,
           "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
           "readings": readings}
    if cell.trace:
        out["event_ms"] = event_means(spans)
        out["reduced"] = prog.traced_steps(int(wl["trace_steps"]))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if world == 1:  # the reference reads the rows in this process
        out["arrays"] = prog.arrays
    prog.free()
    return out


def ranks_run(cell: harness.Cell, t_start: float, fn=rank_run,
              *extra) -> list:
    """``fn(cell, t_start, *extra)`` in this process, or on each of the
    cell's cards as the ranks of one process group (``parallel.launch``;
    gloo ranks on the CPU rehearse it)."""
    if cell.chips == 1:
        return [fn(cell, t_start, *extra)]
    from pytorch_pose_estimation_tpu_torch.parallel import mesh

    cuda = torch.device(cell.device).type == "cuda"
    devices = [f"cuda:{r}" if cuda else "cpu" for r in range(cell.chips)]
    return mesh.launch(fn, devices, "nccl" if cuda else "gloo",
                       args=(cell, t_start, *extra))


def check(cell: harness.Cell, first: dict) -> Dict[str, float]:
    """The comparison's numbers: rank 0's checked steps against the
    reference's, on the first card once the ranks have ended."""
    device = torch.device(cell.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    arrays = first.pop("arrays", None) or traffic.cache_arrays(
        cell.traffic, cell.config, cell.seed)
    ref = reference(cell, arrays, device, int(cell.workload["checked_steps"]))
    return judge.train_numbers(first["readings"], ref)


def run(cell: harness.Cell, t_start: float) -> harness.Outcome:
    cfg, wl = cell.config, cell.workload
    ranks = ranks_run(cell, t_start)
    first = ranks[0]
    b = int(cfg["batch_size"])
    images_per_s = first["steps"] * b / first["seconds"]
    out = harness.Outcome(attempted=first["steps"], failed=first["failed"])
    out.memory_peak_bytes = max(r["memory_peak_bytes"] for r in ranks)
    if cell.trace:
        reduced = first["reduced"]
        out.busy_s = sum(r["reduced"]["busy_s"] for r in ranks) / len(ranks)
        out.window_s = sum(r["reduced"]["window_s"] for r in ranks) / \
            len(ranks)
        out.measured = {
            "entry": "train", "images_per_s": images_per_s,
            "flops_per_image": cell.net.train_flops(cfg),
            "chips": cell.chips, "event_ms": first["event_ms"],
            "ops": reduced["ops"], "trace_steps": int(wl["trace_steps"]),
            "k3_bytes": work.bn_act_bytes(
                b // cell.chips * cell.net.bn_act_elements(cfg)),
            "busy_s": out.busy_s, "window_s": out.window_s}
        if cfg["kind"] == "sbp":
            oh, ow = cfg["output_size"]
            out.measured["k1_bytes"] = work.sbp_heatmap_bytes(
                b // cell.chips, int(cfg["num_keypoints"]), oh, ow)
        out.breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}
    else:
        out.e2e = {"train_images_per_s": images_per_s,
                   "setup_s": max(r["setup_s"] for r in ranks)}
    out.checks = judge.checks(check(cell, first), wl["limits"])
    return out
