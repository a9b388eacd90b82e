"""How far the host runs ahead of the device in a train step: the median
over the window's steps of each step's smallest device-marker lead (the
time from a marker's enqueue to the device reaching it; the program's span
recorder, unprofiled). Near 0: the device runs dry and the host sets the
pace."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "train":
        return None
    return _recorder.median([x for i in _recorder.train_intervals()
                             for x in i["leads_ms"]])
