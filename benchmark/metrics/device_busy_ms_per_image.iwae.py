"""Device milliseconds an image scored: the union of kernel, copy and memset
intervals over the profiled call, over its images."""

from benchmark.harness import stretch


def read(s):
    return stretch.busy_ms_per(s, "iwae", "image")
