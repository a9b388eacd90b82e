"""What the per-layer readers read: one profiled stretch of the timed path,
the work the cell's shapes put in it, and one unprofiled stretch of the
same run."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.harness import counts, peaks, trace


@dataclass
class Stretch:
    unit: str                      # "train" or "iwae": what a cell runs
    events: list                   # trace.Event of the profiled stretch
    steps: int = 0                 # train steps in the profiled stretch
    images: int = 0                # images scored in the profiled stretch
    # port kernel -> {"launches", "bytes", "ops"} that the cell's shapes
    # put in the profiled stretch
    kernels: dict = field(default_factory=dict)
    # port kernel -> launches the program counted (``ops.kernels.
    # launches``) over a run of the same path, and the count the shapes
    # give for it
    counted: dict = field(default_factory=dict)
    card: str = ""
    flops_per_image: int = 0       # the configuration's model FLOPs
    timed_images: int = 0          # images in the unprofiled stretch
    timed_seconds: float = 0.0     # its wall, by the host clock

    def busy_s(self) -> float:
        return trace.busy_us(self.events) / 1e6

    def span_s(self) -> float:
        s, e = trace.span_us(self.events)
        return (e - s) / 1e6


def idle_share(s: Stretch, unit: str) -> float | None:
    if s.unit != unit or not s.events:
        return None
    busy = s.busy_s()
    return 100.0 * (1.0 - busy / s.span_s()) if busy > 0 else None


def busy_ms_per(s: Stretch, unit: str, per: str) -> float | None:
    n = s.steps if per == "step" else s.images
    if s.unit != unit or not s.events or n <= 0:
        return None
    busy = s.busy_s()
    return 1e3 * busy / n if busy > 0 else None


def dispatch_ms_per_step(s: Stretch, unit: str) -> float | None:
    if s.unit != unit or not s.events or s.steps <= 0:
        return None
    return 1e3 * (s.span_s() - trace.blocked_us(s.events) / 1e6) / s.steps


# the program's hand-written kernels, named by their ``__global__``
# functions in its CUDA sources
CSRC = Path(__file__).resolve().parents[2] / "apv_tpu_torch" / "ops" / "csrc"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(?:void\s+)?(\w+)\s*[(<]")


def port_functions() -> list[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    found = set()
    for path in sorted(CSRC.glob("*.cu*")):
        found.update(_GLOBAL.findall(path.read_text()))
    return sorted(found)


def roofline_kernels(s: Stretch) -> dict:
    """What the port kernels' roofline share is taken over: ``in``, each
    kernel whose launches in the trace, and in the program's own count,
    are those the cell's shapes give, with its launches and device
    seconds; ``out``, each port kernel that ran in the profiled stretch
    and is left out, with its launches, device seconds and why (its
    launches differ from the shapes', or the cell reckons no shapes for
    it). A kernel that drops out of the share is named here."""
    reckoned = {counts.KERNEL_FUNCTIONS[n]: n for n in s.kernels}
    took, left = {}, {}
    for fn in sorted(set(port_functions()) | set(reckoned)):
        n, us = trace.kernel_calls(s.events, fn)
        name = reckoned.get(fn)
        if name is None:
            if n:
                left[fn] = {"launches": n, "device_s": us / 1e6,
                            "why": "the cell reckons no shapes for it"}
            continue
        want = s.kernels[name]["launches"]
        got, expect = s.counted.get(name, (None, None))
        if n == want and n > 0 and got == expect:
            took[name] = {"launches": n, "device_s": us / 1e6}
        else:
            left[name] = {"launches": n, "device_s": us / 1e6,
                          "why": f"launches: trace {n}, shapes give {want}; "
                                 f"program's count {got}, shapes give "
                                 f"{expect}"}
    return {"in": took, "out": left}


def kernel_roofline(s: Stretch, unit: str) -> float | None:
    """Σ least time ÷ Σ device time over the ``in`` kernels of
    ``roofline_kernels``; None where there is none."""
    if s.unit != unit or not s.events:
        return None
    least = device = 0.0
    bw = peaks.mem_bw(s.card)
    for name, k in roofline_kernels(s)["in"].items():
        want = s.kernels[name]
        least += counts.least_seconds(want["bytes"], want["ops"], bw,
                                      peaks.F32_OPS)
        device += k["device_s"]
    return 100.0 * least / device if device > 0 else None


def mfu(s: Stretch, unit: str) -> float | None:
    if s.unit != unit or s.timed_seconds <= 0 or s.timed_images <= 0:
        return None
    return (100.0 * s.flops_per_image * s.timed_images / s.timed_seconds
            / peaks.BF16_TENSOR_OPS)
