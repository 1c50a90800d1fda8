"""A request's model FLOPs (the forward's convolutions, from the shapes)
times the window's requests per second, over the chip's bf16 peak."""

from posebench import work


def read(m):
    if m.get("entry") != "infer":
        return None
    return work.mfu_percent(m["flops_per_request"], m["requests_per_s"],
                            m["chips"])
