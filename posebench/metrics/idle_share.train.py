"""Share of the profiled window in which no operation ran on the device
(the union of the device's operation intervals against the window)."""


def read(m):
    if m.get("entry") != "train":
        return None
    return 100.0 * (1.0 - m["busy_s"] / m["window_s"])
