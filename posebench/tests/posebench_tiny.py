"""Small cells for the CPU tests: the real files, shrunk; torch's count of
a network's FLOPs."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from posebench import harness

# thresholds for the small cells, above what sound runs read there and
# under what the faults read (test_posebench_faults.py)
TINY_LIMITS = {"train": {"loss_gap": 0.01, "grad_gap": 0.1,
                         "grad_gap_head": 0.1, "grad_gap_bn": 0.1,
                         "update_gap": 0.1, "update_gap_head": 0.1,
                         "update_gap_bn": 0.1},
               "infer": {"peak_gap": 0.05, "conf_gap": 0.01}}


# cells whose files are here and whose BENCHMARK.json entries a later PR
# adds: data-parallel SBP over four cards, one-crop SBP serving (PERF.md,
# Open questions)
PENDING = [{"name": "sbp_train_dp4", "config": "sbp_coco",
            "traffic": "sbp_cache_coco", "chips": 4, "why": "pending"},
           {"name": "sbp_infer_b1", "config": "sbp_coco",
            "traffic": "person_crops", "chips": 1, "why": "pending"}]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]] + \
    [w["name"] for w in PENDING]


def tiny(name: str, seed: int = 3, seconds: float = 0.5, bench=None,
         base=harness.BENCH) -> harness.Cell:
    """The cell ``name`` (of ``bench``, with its files under ``base``) at
    a size a CPU test can hold, in float32."""
    bench = harness.benchmark() if bench is None else bench
    bench = dict(bench, workloads=bench["workloads"] + PENDING)
    c = harness.load_cell(name, bench, base)
    c.device, c.seconds, c.seed = "cpu", seconds, seed
    c.config["precision"] = "fp32"
    if c.config["kind"] == "sbp":
        c.config.update(input_size=[64, 32], output_size=[16, 8],
                        batch_size=8, train_instances=40)
    else:
        c.config.update(input_size=64, output_size=16, batch_size=4,
                        train_instances=12)
    c.traffic["distinct"] = 8
    if c.traffic["kind"] == "pool":
        c.traffic.update(pool=32)
        c.workload.update(checked_requests=4, warmup_requests=2)
    c.workload["limits"] = dict(TINY_LIMITS[c.workload["entry"]])
    return c


def flops_counted(net, cfg: dict):
    """torch's count of one image's forward, and of its forward and
    backward, through the network file's interface."""
    w = net.weights(cfg, 0, "cpu")
    leaves = [w[k].requires_grad_() for k in net.groups(cfg)]
    size = cfg["input_size"]
    hw = (size, size) if isinstance(size, int) else tuple(size)
    x = torch.rand(1, 3, *hw)
    with FlopCounterMode(display=False) as fwd:
        y = net.forward(w, x, cfg, True)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(y.square().sum(), leaves)
    return fwd.get_total_flops(), fwd.get_total_flops() + \
        bwd.get_total_flops()
