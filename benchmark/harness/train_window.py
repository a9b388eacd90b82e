"""The timed window of a training cell, as ``kinds/train_loop.py`` times the
flagship's, for a traffic kind that brings its own model and objective
(``kinds/train_hier.py``): three warm-up calls of
``steps_per_call`` steps, then one resumed ``train_loop`` call timed
between its read-back points over two record intervals at
least (the recorder's readers leave out the first, the loop's start), and
with ``--trace 1`` the loop's profiler window in one more call after it.
The port kernels of the profiled stretch, the model FLOPs and the
readings of ``correct`` are the kind's."""

from __future__ import annotations

import json
import math
import time

import torch

from benchmark.harness import tap
from benchmark.harness import trace as T
from benchmark.harness.stretch import Stretch
from benchmark.kinds import train_loop as flat


def run(ctx, prep, *, check_steps: int, per_step: dict,
        flops_per_image) -> dict:
    """The window's result (``measured``, ``attempted``, ``failed``,
    ``memory_peak_bytes``, ``notes`` and, traced, ``stretch``) after the
    prepared run ``prep`` (``start``, ``arrays``, ``run_dir``) has taken
    its ``check_steps`` checked steps. ``per_step``: port kernel ->
    {"launches", "bytes", "ops"} of one step; ``flops_per_image``: a
    callable giving the model FLOPs of an image's step."""
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.loop import train_loop

    dev = ctx.device
    t = ctx.config_tree["train"]
    b, k, log_every = t["batch_size"], t["steps_per_call"], t["log_every"]
    phases = {"checked_steps": time.perf_counter() - ctx.t0}
    with tap.RecordTap() as warm:
        train_loop(flat._config(ctx, log_every=k), max_steps=3 * k,
                   arrays=prep.arrays, resume=True, device=dev)
    (ta, _), (tb, _) = warm.records[-2:]
    t_step = (tb - ta) / k
    phases["warm_up"] = time.perf_counter() - ctx.t0

    s0 = prep.start + check_steps + 3 * k
    r1 = -(-s0 // log_every) * log_every      # the window's first record
    n_int = max(2, round(ctx.seconds / (log_every * t_step)))
    n_steps = -(-(r1 + n_int * log_every - s0 + 1) // k) * k
    before = dict(K.launches)
    steal0 = tap.host_steal()
    with tap.RecordTap() as win:
        train_loop(flat._config(ctx), max_steps=n_steps, arrays=prep.arrays,
                   resume=True, device=dev)
    t_return = time.perf_counter()
    steal1 = tap.host_steal()
    counted = {n: K.launches[n] - before[n] for n in K.launches}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    def done_at(step: int) -> int:       # steps finished at its read-back
        return s0 + ((step - s0) // k + 1) * k

    recs = [(tt, s) for tt, s in win.records if s % log_every == 0]
    (t_first, s_first), (t_last, s_last) = recs[0], recs[-1]
    phases["first_record"] = t_first - ctx.t0
    steps_timed = done_at(s_last) - done_at(s_first)
    span = t_last - t_first
    window = [json.loads(x) for x in (prep.run_dir / "metrics.jsonl")
              .read_text().splitlines()[-len(recs):]]
    failed = sum(1 for r in window if not math.isfinite(r.get("loss",
                                                              math.nan)))
    out = {"measured": {"train_images_per_s": steps_timed * b / span,
                        "setup_s": (t_first - ctx.t0)
                        + (t_return - t_last)},
           "attempted": n_steps, "failed": failed,
           "memory_peak_bytes": peak,
           "notes": {"window_steps": n_steps, "timed_steps": steps_timed,
                     "timed_s": span, "warm_step_ms": 1e3 * t_step,
                     "closing_s": t_return - t_last,
                     "record_gaps_s": [b_[0] - a_[0] for a_, b_ in
                                       zip(recs, recs[1:])],
                     "setup_phases_s": phases,
                     "host_steal_share": None if steal0 is None else
                     (steal1[0] - steal0[0]) / max(1, steal1[1] - steal0[1])}}
    if window and "skipped_updates" in window[-1]:
        out["notes"]["skipped_updates"] = window[-1]["skipped_updates"]

    if ctx.trace:
        trace_dir = ctx.workdir / "trace"
        # one more call after the profiled ones keeps the closing save
        # out of the stretch
        start, stop = flat.profiled_calls(k)
        with tap.RecordTap():
            train_loop(flat._config(ctx), max_steps=stop + k,
                       arrays=prep.arrays, resume=True,
                       trace_dir=str(trace_dir), device=dev)
        (path,) = sorted(trace_dir.glob("*.json"))
        kernels = {name: {key: v * (stop - start) for key, v in w.items()}
                   for name, w in per_step.items()}
        expect = {name: (counted.get(name), w["launches"] * n_steps)
                  for name, w in per_step.items()}
        out["stretch"] = Stretch(
            unit="train", events=T.load(path), steps=stop - start,
            kernels=kernels, counted=expect, card=ctx.card,
            flops_per_image=flops_per_image(),
            timed_images=steps_timed * b, timed_seconds=span)
    return out
