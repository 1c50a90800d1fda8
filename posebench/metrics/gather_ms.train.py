"""Mean device ms a train step spends in the feed's gather
(``next(epoch_batches)``), CUDA events at its edges."""


def read(m):
    if m.get("entry") != "train":
        return None
    return m["event_ms"].get("gather")
