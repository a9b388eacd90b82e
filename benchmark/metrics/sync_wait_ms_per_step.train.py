"""Host milliseconds a train step spends blocked in synchronising calls:
their host time over the window's record intervals, over those intervals'
steps (the program's counter of synchronising calls, unprofiled)."""

from benchmark.metrics import _recorder


def read(s):
    intervals = _recorder.train_intervals() if s.unit == "train" else []
    if not intervals:
        return None
    return (sum(i["sync_wait_ms"] for i in intervals)
            / sum(i["steps"] for i in intervals))
