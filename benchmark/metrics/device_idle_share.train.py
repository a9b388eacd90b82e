"""Percent of the profiled train stretch in which the device ran nothing."""

from benchmark.harness import stretch


def read(s):
    return stretch.idle_share(s, "train")
