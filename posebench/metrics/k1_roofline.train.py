"""K1 (csrc/heatmap.cu) against its least time: the joints read and the
heatmaps written once at the HBM rate, over its mean device time in the
profiled steps."""

from posebench import trace, work


def read(m):
    if m.get("entry") != "train" or "k1_bytes" not in m:
        return None
    t = trace.seconds_per_call(m["ops"], "sbp_heatmaps")
    return None if t is None else work.roofline_percent(m["k1_bytes"], t)
