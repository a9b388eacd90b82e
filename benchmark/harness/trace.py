"""Reading a profiled stretch: a Chrome trace of ``torch.profiler`` with the
CPU and CUDA activities.

* Device time is the union of the intervals of kernels, copies and
  memsets: overlapping work counts once.
* The stretch is the span from the first event to the last, host and
  device alike; its idle share is 1 − the union over it.
* Host time blocked on the device is the time inside the CUDA runtime's
  synchronising calls and copies.
* An idle gap is a stretch of the device's timeline with no device work,
  named by the innermost host operation under way where it starts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BLOCKING = ("Synchronize", "Memcpy")       # CUDA runtime calls that wait


@dataclass
class Event:
    name: str
    cat: str
    start: float          # µs
    end: float            # µs


def load(path: str | Path) -> list[Event]:
    with open(path) as f:
        raw = json.load(f)
    items = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [Event(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
                  float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in items if e.get("ph") == "X" and "ts" in e]


def device_events(events: list[Event]) -> list[Event]:
    return [e for e in events if e.cat in DEVICE_CATS]


def merge(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: list[Event]) -> float:
    return sum(e - s for s, e in merge((d.start, d.end)
                                       for d in device_events(events)))


def span_us(events: list[Event]) -> tuple[float, float]:
    return min(e.start for e in events), max(e.end for e in events)


def blocked_us(events: list[Event]) -> float:
    """Host time inside CUDA runtime calls that wait for the device."""
    return sum(e.end - e.start for e in events
               if e.cat in ("cuda_runtime", "cuda_driver")
               and any(b in e.name for b in BLOCKING))


def by_name(events: list[Event], n: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    tot: dict[str, float] = {}
    for d in device_events(events):
        tot[d.name] = tot.get(d.name, 0.0) + (d.end - d.start)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in top]


def kernel_calls(events: list[Event], function: str) -> tuple[int, float]:
    """(launches, device µs) of the kernels whose name holds
    ``function`` as a whole identifier (``::f(`` or ``::f<``, or the
    name itself)."""
    n, us = 0, 0.0
    for d in device_events(events):
        if d.cat != "kernel":
            continue
        nm = d.name
        if (f"::{function}(" in nm or f"::{function}<" in nm
                or nm.startswith(f"{function}(") or nm.startswith(
                    f"{function}<") or nm == function
                or f" {function}(" in nm or f" {function}<" in nm):
            n += 1
            us += d.end - d.start
    return n, us


def idle_gaps(events: list[Event], n: int = 10) -> list[list]:
    """The device's idle gaps inside the stretch, summed by the innermost
    host operation under way where each starts: [name, seconds], the
    longest first."""
    start, end = span_us(events)
    busy = merge((d.start, d.end) for d in device_events(events))
    gaps, at = [], start
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if end > at:
        gaps.append((at, end))
    host = sorted((e for e in events if e.cat in ("cpu_op", "cuda_runtime",
                                                  "cuda_driver",
                                                  "user_annotation")),
                  key=lambda e: e.start)
    tot: dict[str, float] = {}
    active: list[Event] = []
    i = 0
    for gs, ge in gaps:                   # in order of start
        while i < len(host) and host[i].start <= gs:
            active.append(host[i])
            i += 1
        active = [h for h in active if h.end > gs]
        # the latest-starting operation under way is the innermost
        name = (max(active, key=lambda h: h.start).name if active
                else "host: no traced operation")
        tot[name] = tot.get(name, 0.0) + (ge - gs)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in top]
