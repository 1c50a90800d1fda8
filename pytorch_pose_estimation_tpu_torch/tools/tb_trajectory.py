"""A validation trajectory table from a run's TensorBoard event files, or,
where tensorboardX is missing, from the Trainer's printed epoch lines.
Counterpart of the repo's tools/tb_trajectory.py (same table, argv and
exit codes):

    python -m pytorch_pose_estimation_tpu_torch.tools.tb_trajectory \\
        saved/<run>/version_0 [--steps-per-epoch N] [--tags val_loss,val_mAP]
    python -m pytorch_pose_estimation_tpu_torch.tools.tb_trajectory \\
        --log train.log [--steps-per-epoch N]

The event files are read as a TFRecord stream (8-byte length and crc
framing, Event protos through tensorboardX's bundled definitions), so no
TensorBoard install is needed; tensorboardX is imported only there.  A step
logged more than once (a resumed run, overlapping event files) gives one
row, with the value written last.  ``--log`` reads the Trainer's
``epoch E: val_loss=... val_mAP=...`` lines of a run's standard output; a
validation after epoch E is logged at step (E + 1) * N, so with
``--steps-per-epoch N`` the table is the event files' table.  Exit 1 when
a tag is missing.
"""

import argparse
import glob
import os
import re
import struct
import sys

# the Trainer's line after each validation round
VAL_LINE = re.compile(
    r"^epoch (\d+): val_loss=(\S+) val_mAP=(\S+)\s*$", re.M)
LOG_TAGS = ("val_loss", "val_mAP")


def read_events(path):
    """Yield Event protos from one event file (TFRecord framing)."""
    from tensorboardX.proto import event_pb2

    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            payload = f.read(length)
            f.read(4)  # payload crc
            if len(payload) < length:
                return
            ev = event_pb2.Event()
            ev.ParseFromString(payload)
            yield ev


def scalars(logdir):
    """tag -> list of (step, value) in the order written, over all event
    files (their names sort by creation time)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.*"))):
        for ev in read_events(path):
            for v in ev.summary.value:
                if v.HasField("simple_value"):
                    out.setdefault(v.tag, []).append(
                        (ev.step, v.simple_value))
    return out


def log_scalars(text, steps_per_epoch=None):
    """tag -> list of (key, value) from the Trainer's validation lines:
    key = the step of the logged value with ``steps_per_epoch``, else the
    epoch."""
    out = {t: [] for t in LOG_TAGS}
    for m in VAL_LINE.finditer(text):
        epoch = int(m.group(1))
        key = (epoch + 1) * steps_per_epoch if steps_per_epoch else epoch
        for tag, value in zip(LOG_TAGS, m.group(2, 3)):
            out[tag].append((key, float(value)))
    return {t: s for t, s in out.items() if s}


def table(data, tags, steps_per_epoch=None, key="step"):
    """The table's lines: one row per step (or epoch), the last value
    written for each tag, '-' where a tag has none."""
    by_key = [dict(data[t]) for t in tags]  # the last write wins
    cols = " | ".join(tags)
    lines = [f"| {key} | epoch | {cols} |" if steps_per_epoch
             else f"| {key} | {cols} |"]
    for k in sorted(by_key[0]):
        vals = " | ".join(
            f"{d[k]:.4g}" if k in d else "-" for d in by_key)
        if steps_per_epoch:
            lines.append(f"| {k} | {k // steps_per_epoch} | {vals} |")
        else:
            lines.append(f"| {k} | {vals} |")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir", nargs="?", default=None)
    ap.add_argument("--log", default=None,
                    help="a run's standard output instead of event files")
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="annotate rows with epoch = step // N")
    ap.add_argument("--tags", default="val_loss,val_mAP")
    args = ap.parse_args(argv)
    if (args.logdir is None) == (args.log is None):
        ap.error("give either a log directory or --log FILE")
    if args.log is not None:
        with open(args.log) as f:
            data = log_scalars(f.read(), args.steps_per_epoch)
        key = "step" if args.steps_per_epoch else "epoch"
    else:
        data, key = scalars(args.logdir), "step"
    tags = args.tags.split(",")
    for t in tags:
        if t not in data:
            print(f"(tag {t!r} not found; have {sorted(data)})",
                  file=sys.stderr)
            return 1
    print("\n".join(table(data, tags, args.steps_per_epoch
                          if key == "step" else None, key)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
