"""Model FLOPs of the images scored in the unprofiled window, over its wall,
as a percent of the card's dense bfloat16 peak."""

from benchmark.harness import stretch


def read(s):
    return stretch.mfu(s, "iwae")
