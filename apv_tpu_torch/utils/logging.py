"""Metrics logging and the profiler window (counterpart of
``apv_tpu/utils/logging.py``).

Structured stdout and ``metrics.jsonl`` in the results dir, with the step
time and images/s between logged steps, and unconditional records
(validation) through ``log_now``. A metric is read back from the device
only at a logged step.

With ``trace_dir``, ``maybe_trace`` runs one ``torch.profiler`` window over
``trace_steps`` (default steps 10 to 15), counted from this run's first
step (``trace_offset``: a resumed run traces its own steps 10-15): it
starts at the call that holds the window's first step and stops at the
first call boundary past its last, then writes a Chrome trace
``trace_steps_<a>-<b>.json`` (absolute steps) into ``trace_dir``. A run
that ends inside the window writes it in ``close()``. The CUDA activity is
traced when ``trace_cuda``.

Under a process group only rank 0 creates the dir, writes ``metrics.jsonl``
and the JSON files and prints: the other ranks' records (group means, the
loop reduces them) would be copies. ``images_per_sec`` counts the global
batch over the group, ``images_per_sec_per_chip`` that over the ranks.
Every rank traces its own window, into ``trace_steps_<a>-<b>.rank<r>.json``
when the group has more than one rank.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from apv_tpu_torch.parallel import multihost


class MetricLogger:
    def __init__(self, results_dir: str | Path, *, log_every: int = 100,
                 batch_size: int = 0, trace_dir: str | Path | None = None,
                 trace_steps: tuple[int, int] = (10, 15),
                 trace_offset: int = 0, trace_cuda: bool = False):
        self.dir = Path(results_dir)
        self.primary = multihost.process_index() == 0
        self.world = multihost.process_count()
        if self.primary:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.jsonl"
        self.log_every = log_every
        self.batch_size = batch_size
        self._last_time = time.perf_counter()
        self._last_step = None
        self.trace_dir = None if trace_dir is None else Path(trace_dir)
        self.trace_steps = (trace_steps[0] + trace_offset,
                            trace_steps[1] + trace_offset)
        self.trace_cuda = trace_cuda
        self._prof = None

    def maybe_trace(self, step: int, stride: int = 1) -> None:
        """Start or stop the window before the call of ``stride`` steps
        that begins at ``step``."""
        if self.trace_dir is None:
            return
        if self._prof is None and step <= self.trace_steps[0] < step + stride:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.trace_cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif self._prof is not None and step + stride > self.trace_steps[1]:
            self._stop_trace()

    def _stop_trace(self) -> None:
        import torch
        if self.trace_cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        a, b = self.trace_steps
        rank = (f".rank{multihost.process_index()}" if self.world > 1
                else "")
        self._prof.export_chrome_trace(
            str(self.trace_dir / f"trace_steps_{a}-{b}{rank}.json"))
        self._prof, self.trace_dir = None, None          # one window

    def close(self) -> None:
        """Write the window's trace if the run ended inside it."""
        if self._prof is not None:
            self._stop_trace()

    def log(self, step: int, metrics: dict) -> None:
        if step % self.log_every != 0 or not self.primary:
            return
        record = {"step": step}
        record.update({k: float(v) for k, v in metrics.items()})
        now = time.perf_counter()       # after the read-back: device done
        if self._last_step is not None and step > self._last_step:
            dt = (now - self._last_time) / (step - self._last_step)
            record["step_time_s"] = dt
            if self.batch_size:
                # batch_size is the global batch, over the group's cards
                record["images_per_sec_per_chip"] = (self.batch_size / dt
                                                     / self.world)
                if self.world > 1:
                    record["images_per_sec"] = self.batch_size / dt
        self._last_time, self._last_step = now, step
        self._write(record)

    def log_now(self, step: int, metrics: dict) -> None:
        """One record whatever ``log_every`` says (validation results)."""
        if not self.primary:
            return
        self._write({"step": step,
                     **{k: float(v) for k, v in metrics.items()}})

    def _write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        parts = [f"step {record['step']}"] + [
            f"{k}={v:.4g}" for k, v in record.items() if k != "step"]
        print("  ".join(parts), flush=True)

    def write_json(self, name: str, obj) -> None:
        if not self.primary:
            return
        with open(self.dir / name, "w") as f:
            json.dump(obj, f, indent=2, default=str)
