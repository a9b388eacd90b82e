"""Model FLOPs of the images trained in the unprofiled stretch, over its wall,
as a percent of the card's dense bfloat16 peak."""

from benchmark.harness import stretch


def read(s):
    return stretch.mfu(s, "train")
