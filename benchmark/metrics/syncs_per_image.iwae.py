"""Synchronising calls an image scored: the program's counter over the
window's ``evaluate_nll`` calls, over their images (unprofiled)."""

from benchmark.metrics import _recorder


def read(s):
    calls = _recorder.iwae_calls() if s.unit == "iwae" else []
    images = sum(c.get("images", 0) for c in calls)
    return sum(c["syncs"] for c in calls) / images if images else None
