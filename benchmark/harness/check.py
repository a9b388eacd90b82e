"""The numbers that decide ``correct`` and their limits."""

from __future__ import annotations

import math
import statistics


def leaf_gaps(prog: dict, ref: dict, *, exclude=()) -> tuple[float, object]:
    """The worst leaf's gap between two per-leaf norms: |n_prog − n_ref|
    over the larger of n_ref and the median n_ref of its group (the first
    item of a leaf's key). Returns (gap, leaf)."""
    if set(prog) != set(ref):
        return math.inf, sorted(set(prog) ^ set(ref), key=str)[:3]
    medians = {}
    for group in {k[0] for k in ref}:
        medians[group] = statistics.median(v for k, v in ref.items()
                                           if k[0] == group)
    worst, at = 0.0, None
    for k, r in ref.items():
        if k in exclude:
            continue
        gap = abs(prog[k] - r) / max(r, medians[k[0]], 1e-30)
        if not math.isfinite(prog[k]):
            gap = math.inf
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def negligible(grads: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is under ``share`` of its group's
    median leaf's: nought to rounding, moved by Adam's round-off alone."""
    medians = {g: statistics.median(v for k, v in grads.items() if k[0] == g)
               for g in {k[0] for k in grads}}
    return {k for k, v in grads.items() if v < share * medians[k[0]]}


def verdict(numbers: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number finite and at or
    under its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks
