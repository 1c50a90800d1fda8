"""K3 (csrc/bn_act.cu) against its least time: its bytes a train step
(``work.bn_act_bytes`` of the network's BN + ReLU elements and this card's
rows) at the HBM rate, over the mean device time a profiled step spends in
K3's six kernels, matched by their function names (cuDNN's and torch's own
BN kernels hold other names)."""

import re

from posebench import work

K3 = re.compile(r"\b(bn_stats|bn_finalize|bn_apply|bn_grad_sums|"
                r"bn_grad_finalize|bn_grad_apply)_kernel\b")


def read(m):
    if m.get("entry") != "train" or "k3_bytes" not in m:
        return None
    times = [t for name, ts in m["ops"].items() if K3.search(name)
             for t in ts]
    if not times:
        return None
    return work.roofline_percent(m["k3_bytes"], sum(times) /
                                 m["trace_steps"])
