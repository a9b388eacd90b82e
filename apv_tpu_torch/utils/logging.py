"""Metrics logging (counterpart of ``apv_tpu/utils/logging.py``).

Structured stdout and ``metrics.jsonl`` in the results dir, with the step
time and images/s between logged steps, and unconditional records
(validation) through ``log_now``. A metric is read back from the device
only at a logged step. The reference's profiler window
(``trace_dir``) is not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, results_dir: str | Path, *, log_every: int = 100,
                 batch_size: int = 0):
        self.dir = Path(results_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.jsonl"
        self.log_every = log_every
        self.batch_size = batch_size
        self._last_time = time.perf_counter()
        self._last_step = None

    def log(self, step: int, metrics: dict) -> None:
        if step % self.log_every != 0:
            return
        record = {"step": step}
        record.update({k: float(v) for k, v in metrics.items()})
        now = time.perf_counter()       # after the read-back: device done
        if self._last_step is not None and step > self._last_step:
            dt = (now - self._last_time) / (step - self._last_step)
            record["step_time_s"] = dt
            if self.batch_size:
                # the single-card path: per chip = per run
                record["images_per_sec_per_chip"] = self.batch_size / dt
        self._last_time, self._last_step = now, step
        self._write(record)

    def log_now(self, step: int, metrics: dict) -> None:
        """One record whatever ``log_every`` says (validation results)."""
        self._write({"step": step,
                     **{k: float(v) for k, v in metrics.items()}})

    def _write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        parts = [f"step {record['step']}"] + [
            f"{k}={v:.4g}" for k, v in record.items() if k != "step"]
        print("  ".join(parts), flush=True)

    def write_json(self, name: str, obj) -> None:
        with open(self.dir / name, "w") as f:
            json.dump(obj, f, indent=2, default=str)
