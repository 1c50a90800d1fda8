"""Mean device ms a train step spends in the forward, loss and backward, from
the step's "targets" marker to "forward_backward"."""


def read(m):
    if m.get("entry") != "train":
        return None
    return m["event_ms"].get("fwd_bwd")
