"""Mean device ms a train step spends in the gradients' all-reduce, from
"forward_backward" to "all_reduce" (rank 0; only with several ranks)."""


def read(m):
    if m.get("entry") != "train":
        return None
    return m["event_ms"].get("all_reduce")
