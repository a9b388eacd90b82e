"""Host cost of the span recorder (``apv_tpu_torch/utils/logging.py``) on a
CUDA card: microseconds a span (enter and exit), a CUDA event record, an
``elapsed_time`` and a ``query``, a device marker (recorded in a span) and
its resolution at a synchronising call, a calibration, and the counting of
a read-back; then what a flagship train step and an IWAE batch of
``iwae_eval`` pay, from the spans, markers and calls they make.

    python3 scripts/recorder_cost.py [--out FILE]

prints one JSON line (and writes it to ``--out``). A train step makes five
spans (``loop.step`` with a marker at each end, ``step.g_phase`` and
``step.d_phase`` with one, ``step.g_opt``, ``step.d_opt``) and an eighth
of a ``loop.data`` at 8 steps a call, and resolves its four markers at a
read-back; an IWAE batch of 64 images at k=1000, chunk 25, makes an
``eval.batch`` and 40 ``eval.chunk`` spans with a marker each and 3
counted synchronising calls, each followed by a calibration.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from apv_tpu_torch.utils import logging as L  # noqa: E402

N = 20_000


def _us(fn, n: int = N) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    rec = L.Recorder()
    x = torch.ones((), device=dev)
    stream = torch.cuda.current_stream(dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record(stream)
    b.record(stream)
    torch.cuda.synchronize()

    def plain():
        with rec.span("x"):
            pass

    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    out["span_us"] = _us(plain)
    out["read_us"] = _us(lambda: rec.read(x), 2000) - _us(
        lambda: float(x), 2000)
    out["event_record_us"] = _us(lambda: a.record(stream))
    torch.cuda.synchronize()
    out["elapsed_time_us"] = _us(lambda: a.elapsed_time(b))
    out["query_us"] = _us(b.query)
    with rec.invocation("cost", dev):
        rec.read(x)                               # the first calibration
        for r in range(3):                        # the last round is timed
            t_mark = time.perf_counter()
            for j in range(L.POOL // 2):
                with rec.span("m", unit=j, marks="both"):
                    pass
            t_mark = time.perf_counter() - t_mark
            torch.cuda.synchronize()
            t_res = time.perf_counter()
            rec.calibrate()
            t_res = time.perf_counter() - t_res
    n = 2 * (L.POOL // 2)
    out["span_two_markers_us"] = 1e6 * t_mark / (n // 2)
    out["marker_us"] = (out["span_two_markers_us"] - out["span_us"]) / 2
    out["resolve_us_per_marker"] = 1e6 * t_res / n
    torch.cuda.synchronize()
    with rec.invocation("cost", dev):
        out["calibrate_us"] = _us(rec.calibrate, 2000)
    marker = out["marker_us"] + out["resolve_us_per_marker"]
    wait = out["calibrate_us"] + out["read_us"]
    out["train_step_us"] = (5 + 1 / 8) * out["span_us"] + 4 * marker
    out["iwae_batch_us"] = (41 * (out["span_us"] + marker) + 3 * wait)
    out["iwae_batch_us_batch_marker_only"] = (41 * out["span_us"] + marker
                                              + 3 * wait)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
