"""Device milliseconds a train step: the union of kernel, copy and memset
intervals over the profiled stretch, over its steps."""

from benchmark.harness import stretch


def read(s):
    return stretch.busy_ms_per(s, "train", "step")
