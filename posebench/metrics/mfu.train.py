"""The whole step's model FLOPs (convolutions, forward and backward, from
the shapes) per image times the window's images per second, over the
chips' bf16 peak."""

from posebench import work


def read(m):
    if m.get("entry") != "train":
        return None
    return work.mfu_percent(m["flops_per_image"], m["images_per_s"],
                            m["chips"])
