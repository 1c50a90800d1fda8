"""Mean device ms a train step spends in the optimizer, from
"forward_backward" (or "all_reduce") to the "optimizer" marker."""


def read(m):
    if m.get("entry") != "train":
        return None
    return m["event_ms"].get("optimizer")
