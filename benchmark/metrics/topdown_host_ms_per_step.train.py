"""Host milliseconds a train step spends in the hierarchical family's
top-down pass, forward: the ``model.topdown`` span's host time (the
program's span recorder, unprofiled), the median over the window's record
intervals of their sum over the interval's steps. A program without the
span gives None."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "train":
        return None
    return _recorder.median([
        i["span_ms"]["model.topdown"] / i["steps"]
        for i in _recorder.train_intervals()
        if "model.topdown" in i.get("span_ms", {})])
