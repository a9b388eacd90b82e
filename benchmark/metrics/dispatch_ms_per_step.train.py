"""Host milliseconds a train step spends dispatching: the profiled stretch's
wall less the host's time blocked in CUDA synchronisation and copies, over
its steps."""

from benchmark.harness import stretch


def read(s):
    return stretch.dispatch_ms_per_step(s, "train")
