"""Mean device ms a train step spends in the augmentation, from the fed batch
to the step's "augment" marker."""


def read(m):
    if m.get("entry") != "train":
        return None
    return m["event_ms"].get("augment")
