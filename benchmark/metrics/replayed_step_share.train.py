"""Percent of the window's train steps that the program ran by replaying a
captured step: replayed steps over steps, summed over the window's record
intervals (the program's counts of its captured step, unprofiled). A
program without those counts gives None."""

from benchmark.metrics import _recorder


def read(s):
    if s.unit != "train":
        return None
    intervals = [i for i in _recorder.train_intervals()
                 if "replayed_steps" in i]
    steps = sum(i["steps"] for i in intervals)
    if steps <= 0:
        return None
    return 100.0 * sum(i["replayed_steps"] for i in intervals) / steps
