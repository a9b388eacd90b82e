"""Device milliseconds a train step spends in the hierarchical family's
top-down pass, forward: the device time between the ``model.topdown``
span's start and end markers (the program's span recorder, unprofiled),
the median over the window's record intervals of their sum over the
interval's steps. A program without the span or its markers gives None."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "train":
        return None
    return _recorder.median([
        i["device_ms"]["model.topdown"] / i["steps"]
        for i in _recorder.train_intervals()
        if "model.topdown" in i.get("device_ms", {})])
