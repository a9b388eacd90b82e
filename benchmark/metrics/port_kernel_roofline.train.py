"""The port kernels' share of their roofline in a train step: the least time
of their launches (bytes at the card's bandwidth or float32 operations at
its peak, whichever is longer) over their device time, in percent."""

from benchmark.harness import stretch


def read(s):
    return stretch.kernel_roofline(s, "train")
