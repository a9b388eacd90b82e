"""Host milliseconds a train step spends in ``train_step``: the median over
the window's record intervals of the ``loop.step`` spans' host time over
their steps (the program's span recorder, unprofiled)."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "train":
        return None
    return _recorder.median([i["step_ms"] / i["steps"]
                             for i in _recorder.train_intervals()])
