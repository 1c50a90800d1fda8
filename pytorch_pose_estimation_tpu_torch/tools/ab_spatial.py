"""Time ``parallel.spatial_forward`` of this checkout against another
checkout's ``parallel/spatial.py``, alternated in the same two rank
processes (two ranks sharing one card over gloo), so that a change to the
halo path is compared without the spread between processes or calls.

    python -m pytorch_pose_estimation_tpu_torch.tools.ab_spatial \\
        --before build/parent/pytorch_pose_estimation_tpu_torch/parallel/spatial.py

For SBP at 256x192 and SPM at 512x512, batch 1, fp32 with TF32 off,
cuDNN deterministic and seeded weights, each rank checks that both
versions give bitwise equal rows, then times ``--pairs`` pairs of
``--reps`` forwards (host clock, the card synchronized; which version
goes first alternates) and prints each side's median, the before side's
quartiles and how many pairs the change won.  ``--device cpu`` runs a small rehearsal (64x64).  Two ranks on one
card are not a scaling figure.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
import time


def _load_before(path: str):
    """``path`` as a module of the port's ``parallel`` package, so that its
    relative imports resolve to this checkout's ``mesh`` and layers."""
    name = "pytorch_pose_estimation_tpu_torch.parallel._spatial_before"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "pytorch_pose_estimation_tpu_torch.parallel"
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _ms(forward, model, rows, reps: int, device: str) -> float:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        forward(model, rows)
    if device == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_body(before_path: str, pairs: int, reps: int, device: str) -> dict:
    import torch

    from .. import parallel
    from ..models import SBP, SPM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # else a call's sums vary
    torch.backends.cudnn.benchmark = False
    before = _load_before(before_path)
    sizes = ((256, 192), (512, 512)) if device == "cuda" else ((64, 64),) * 2
    out = {}
    for (name, cls), hw in zip((("sbp", SBP), ("spm", SPM)), sizes):
        torch.manual_seed(0)
        model = cls(17).to(device).eval()
        x = torch.randn(1, 3, *hw, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            rows = parallel.spatial_rows(x.to(device))
            a = before.spatial_forward(model, rows)
            b = parallel.spatial_forward(model, rows)
            times = {"before": [], "after": []}
            for i in range(pairs):
                order = (("after", parallel.spatial_forward),
                         ("before", before.spatial_forward))
                for side, forward in order[::-1] if i % 2 == 0 else order:
                    times[side].append(_ms(forward, model, rows, reps,
                                           device))
        out[name] = {"equal": bool(torch.equal(a, b)),
                     "max_diff": float((a - b).abs().max()), **times}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", required=True,
                        help="the other checkout's parallel/spatial.py")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    from .. import parallel

    devices = ["cuda:0" if args.device == "cuda" else "cpu"] * 2
    results = parallel.launch(rank_body, devices, backend="gloo",
                              args=(args.before, args.pairs, args.reps,
                                    args.device))
    ok = True
    for r, out in enumerate(results):
        for name, d in out.items():
            b, a = d["before"], d["after"]
            q = statistics.quantiles(b, n=4)
            wins = sum(x < y for x, y in zip(a, b))
            ok &= d["equal"]
            print(f"rank {r} {name}: bitwise equal {d['equal']} (max diff "
                  f"{d['max_diff']:.3g}); before median "
                  f"{statistics.median(b):.2f} ms (quartiles {q[0]:.2f}-"
                  f"{q[2]:.2f}), after median {statistics.median(a):.2f} ms;"
                  f" after faster in {wins} of {len(a)} pairs")
            print(f"  before {[round(v, 2) for v in b]}")
            print(f"  after  {[round(v, 2) for v in a]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
