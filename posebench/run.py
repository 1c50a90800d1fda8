"""Run one benchmark cell once on the card.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port
(``pytorch_pose_estimation_tpu_torch``).  Set-up makes the inputs and the
weights from ``--seed``, warms up the cell's shapes and drives the first
steps that the comparison checks; the window then measures for
``--seconds``; after it the plain reference judges what the timed path
produced.  The last line of standard output is the result object; the
numbers compared, each beside its limit, are the last lines of standard
error.  ``--trace 1`` reports the cell's per-layer metrics instead of its
end-to-end ones.  Exits non-zero, with no result, without enough cards or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path
sys.path[0] = str(ROOT)

from posebench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = harness.load_cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)
    harness.use_checkout_caches()

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"posebench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    card = harness.card_info()
    print(f"posebench: {cell.name} seed {cell.seed} on "
          f"{torch.cuda.get_device_name(0)} ({card['nvidia_smi']})",
          file=sys.stderr, flush=True)

    entry = harness.entry_module(cell.workload["entry"])
    out = entry.run(cell, T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"posebench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, out, torch.cuda.get_device_name(0),
                               card)
    for text in harness.check_lines(out.checks):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
