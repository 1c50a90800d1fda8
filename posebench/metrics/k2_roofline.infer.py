"""K2 (csrc/decode.cu) against its least time: the logits read and the
joints written once at the HBM rate, over its mean device time in the
profiled requests."""

from posebench import trace, work


def read(m):
    if m.get("entry") != "infer":
        return None
    t = trace.seconds_per_call(m["ops"], "decode_sbp")
    return None if t is None else work.roofline_percent(m["k2_bytes"], t)
