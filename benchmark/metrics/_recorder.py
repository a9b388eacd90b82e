"""What the readers of the program's span recorder share: the invocations
of the timed window, found from the profiled one that a ``--trace 1`` run
makes after it (``apv_tpu_torch.utils.logging.summaries``). A program
without the recorder gives none, and its readers None."""

from __future__ import annotations

import statistics


def _summaries(kind: str) -> list[dict]:
    from apv_tpu_torch.utils import logging
    read = getattr(logging, "summaries", None)
    return [] if read is None else [s for s in read() if s["kind"] == kind]


def _before_profiled(kind: str) -> list[dict]:
    """The unprofiled invocations of ``kind`` just before the newest
    profiled one, back to the profiled one before it or the oldest kept,
    oldest first."""
    runs = _summaries(kind)
    last = max((i for i, s in enumerate(runs) if s["profiled"]), default=None)
    if last is None:
        return []
    first = last
    while first > 0 and not runs[first - 1]["profiled"]:
        first -= 1
    return runs[first:last]


def train_intervals() -> list[dict]:
    """The record intervals of the window's ``train_loop`` invocation (the
    unprofiled one just before the profiled one), but its first, the
    loop's start."""
    runs = _before_profiled("train_loop")
    return runs[-1]["intervals"][1:] if runs else []


def iwae_calls() -> list[dict]:
    """The ``evaluate_nll`` calls before the profiled one, but the oldest
    of them (the first call's one-time costs)."""
    return _before_profiled("evaluate_nll")[1:]


def median(values: list) -> float | None:
    return statistics.median(values) if values else None
