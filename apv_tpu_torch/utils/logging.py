"""Metrics logging, the profiler window and the span recorder (counterpart
of ``apv_tpu/utils/logging.py``; the recorder is the port's own).

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

The recorder (``RECORDER``; ``span``, ``read``, ``waits``, ``invocation``
and ``summaries`` are its module-level handles) is always on and keeps
aggregates only, in memory:

* spans: ``with span(name):`` adds one to the name's count and its host
  nanoseconds of duration and of self time (the duration less that of the
  spans opened inside it), and keeps the last one's start and end, all on
  ``time.time_ns()``, the clock of the profiler's Chrome trace (an event's
  ``ts`` plus the trace's ``baseTimeNanoseconds``, which
  ``tests/test_torch_spans.py`` holds to 0.1 ms). While ``torch.profiler``
  runs, the span also opens a ``record_function`` range of its name: the
  trace holds the program's spans as ``user_annotation`` events. Under
  ``torch.export``, fx or dynamo tracing a span does nothing.
* synchronising calls: ``read(t)`` (``float(t)`` of a tensor) and ``with
  waits(site, n):`` (copies between host memory and the card, ``.cpu()``)
  count each call in which the program waits for the device, and the host
  time blocked there. On the CPU the sites count and block for nothing.
* device markers, on a CUDA device inside an ``invocation``: a span opened
  with ``marks`` records a CUDA timing event from a pool of ``POOL``, and
  the host time it was enqueued at. Right after a synchronising call the
  stream is idle: an event recorded there at host time h is reached by the
  device at ≈ h, and puts every marker recorded after it on the host clock
  once the next synchronising call has waited for them. No call waits for
  a marker. A marker's host lead is the time from its enqueue to the
  device reaching it, at least 0: large where the host runs ahead and the
  device sets the pace, near 0 where the device had run dry. Each unit (a
  span opened with ``unit``: a train step, an IWAE batch) keeps its
  smallest lead; once that reads 0, the unit's later markers are not
  timed. A marker asked for while the pool is empty is dropped and
  counted (``drops``) until the next synchronising call frees the pool.
* the captured step (``training/graph.py``): ``captures`` counts the
  train steps captured in a CUDA graph, ``replayed_steps`` the steps run
  by replaying one (``GRAPH_COUNTS``). While a step is captured
  (``with quiet():``) no span opens and no marker is recorded: its work
  is dispatched again by each replay, not by the host, so the spans
  inside the step (the phases, the optimizers, ``model.*``) are not
  timed on a replayed step; the loop's own spans around it are.
* ``with invocation(kind, device):`` wraps one ``train_loop`` or
  ``evaluate_nll`` call; on exit its summary (the spans, synchronising
  calls, drops, unit leads and captured-step counts of the call, flagged
  ``profiled`` where a profiler ran during it) joins the last ``KEEP``,
  which ``summaries()`` returns.

``MetricLogger.log`` reads the metrics back inside a ``loop.readback``
span, and adds to each record that has ``step_time_s``, per step over the
same interval: ``host_step_ms`` (the ``loop.step`` spans' host time),
``sync_wait_ms`` (host time in synchronising calls), ``host_lead_ms`` (the
median of the steps' smallest leads; only with markers, on the card) and
the self time of the phases and optimizers that ran,
``g_phase_self_ms``, ``d_phase_self_ms``, ``g_opt_self_ms`` and
``d_opt_self_ms``. The interval (those numbers in ms, ``steps``, each
step's lead and the captured step's ``captures`` and ``replayed_steps``)
joins the open ``train_loop`` invocation's ``intervals``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import statistics
import time
from pathlib import Path

import torch
import torch.fx._symbolic_trace as _fx

from apv_tpu_torch.parallel import multihost

POOL = 1024          # CUDA timing events held for device markers
KEEP = 256           # invocation summaries kept
GRAPH_COUNTS = ("captures", "replayed_steps")    # of the captured step

# the train step's spans whose self time a record carries, and its field
STEP_SELF = {"step.g_phase": "g_phase_self_ms",
             "step.d_phase": "d_phase_self_ms",
             "step.g_opt": "g_opt_self_ms",
             "step.d_opt": "d_opt_self_ms"}


def _traced() -> bool:
    """True while torch.export, dynamo or fx traces the caller."""
    return torch.compiler.is_compiling() or _fx._is_fx_tracing_flag


class _Span:
    __slots__ = ("rec", "name", "unit", "marks", "start", "child", "rf",
                 "outer_unit", "live", "first")

    def __init__(self, rec, name, unit, marks):
        self.rec, self.name, self.unit, self.marks = rec, name, unit, marks

    def __enter__(self):
        self.live = not (_traced() or self.rec.capturing)
        if not self.live:
            return self
        rec = self.rec
        self.rf = None
        self.outer_unit = rec.unit
        if self.unit is not None:
            rec.unit = (self.name, self.unit)
        self.child = 0
        rec.stack.append(self)
        if torch.autograd._profiler_enabled():
            # the profiler takes the range's start midway through its entry
            before = time.time_ns()
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
            rec.profiled += 1
            self.start = (before + time.time_ns()) // 2
        else:
            self.start = time.time_ns()
        self.first = None
        if self.marks and rec.stream is not None:
            self.first = rec.mark()
        return self

    def __exit__(self, *exc):
        if not self.live:
            return False
        rec = self.rec
        if self.marks in ("both", "timed") and rec.stream is not None:
            last = rec.mark()
            if self.marks == "timed" and self.first is not None \
                    and last is not None:
                rec.timed.append((self.first, last, self.name))
        if self.rf is not None:
            # the profiler takes the range's end late in its exit
            self.rf.__exit__(*exc)
        end = time.time_ns()
        dur = end - self.start
        rec.stack.pop()
        t = rec.totals.get(self.name)
        if t is None:
            t = rec.totals[self.name] = [0, 0, 0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += dur - self.child
        t[3], t[4] = self.start, end
        if rec.stack:
            rec.stack[-1].child += dur
        rec.unit = self.outer_unit
        return False


class _Wait:
    __slots__ = ("rec", "site", "n", "idle", "start")

    def __init__(self, rec, site, n, idle):
        self.rec, self.site, self.n, self.idle = rec, site, n, idle

    def __enter__(self):
        self.start = (None if _traced() or self.rec.capturing
                      else time.time_ns())
        return self

    def __exit__(self, *exc):
        if self.start is None:
            return False
        ns = time.time_ns() - self.start
        rec = self.rec
        rec.syncs += self.n
        rec.sync_ns += ns
        site = rec.sites.get(self.site)
        if site is None:
            site = rec.sites[self.site] = [0, 0]
        site[0] += self.n
        site[1] += ns
        if self.idle and rec.stream is not None and exc[0] is None:
            rec.calibrate()
        return False


class _Invocation:
    def __init__(self, rec, kind, device):
        self.rec, self.kind = rec, kind
        self.device = torch.device(device)

    def __enter__(self) -> dict:
        rec = self.rec
        self.base = rec.snapshot()
        self.base_sites = {k: v[0] for k, v in rec.sites.items()}
        self.base_other = (rec.drops, rec.profiled)
        self.base_graph = dict(rec.graph)
        self.summary = {"kind": self.kind, "device": str(self.device),
                        "profiled": torch.autograd._profiler_enabled(),
                        "intervals": []}
        if not rec.open and self.device.type == "cuda":
            rec.start_markers(self.device)
        rec.open.append(self)
        return self.summary

    def __exit__(self, *exc):
        rec = self.rec
        rec.open.remove(self)
        if not rec.open:
            rec.stop_markers()
        now = rec.snapshot()
        s = self.summary
        s["spans"] = {}
        for name, (c, ns, self_ns, _, _) in now[0].items():
            c0, ns0, self0, _, _ = self.base[0].get(name, (0,) * 5)
            if c > c0:
                s["spans"][name] = {"count": c - c0, "ms": (ns - ns0) / 1e6,
                                    "self_ms": (self_ns - self0) / 1e6}
        s["syncs"] = now[1] - self.base[1]
        s["sync_wait_ms"] = (now[2] - self.base[2]) / 1e6
        s["sync_sites"] = {k: v[0] - self.base_sites.get(k, 0)
                           for k, v in rec.sites.items()
                           if v[0] > self.base_sites.get(k, 0)}
        s["drops"] = rec.drops - self.base_other[0]
        s.update({k: v - self.base_graph[k] for k, v in rec.graph.items()})
        s["profiled"] = (s["profiled"] or rec.profiled > self.base_other[1]
                         or torch.autograd._profiler_enabled())
        # the unit leads no interval took, in ms by span name in unit order
        leads: dict[str, list] = {}
        for (name, _), ns in sorted(rec.leads.items()):
            leads.setdefault(name, []).append(ns / 1e6)
        rec.leads = {}
        s["unit_leads_ms"] = leads
        rec.summaries.append(s)
        return False


class Recorder:
    """The spans, synchronising calls and device markers of one process
    (module docstring)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Forget everything recorded; leaves no marker pending."""
        # span name -> [count, ns, self ns, the last one's start and end]
        self.totals: dict[str, list] = {}
        self.sites: dict[str, list] = {}      # sync site -> [calls, ns]
        self.syncs = self.sync_ns = 0
        self.drops = 0
        self.profiled = 0                     # spans opened under a profiler
        self.graph = dict.fromkeys(GRAPH_COUNTS, 0)
        self.capturing = False                # a step is being captured
        self.summaries: collections.deque = collections.deque(maxlen=KEEP)
        self.leads: dict[tuple, int] = {}     # unit -> smallest lead, ns
        self.stack: list[_Span] = []
        self.unit = None
        self.open: list[_Invocation] = []
        self.stream = None                    # the marked stream, or None
        self._device = None
        self._pool: list = []
        self._made = 0
        self._pending: list = []              # (event, host ns, unit)
        # a "timed" span's (start, end) markers not yet resolved, and the
        # device ns between them by span name: [count, ns]
        self.timed: list = []
        self.device_ns: dict[str, list] = {}
        self._cal = None                      # (event, host ns), stream idle
        self._spare = None

    # -- the handles -------------------------------------------------------

    def span(self, name: str, *, unit=None, marks: str | None = None):
        """A span of ``name``; ``unit`` (an index) makes it a unit of its
        own, whose markers share one smallest lead; ``marks`` 'start' or
        'both' records a device marker at its start (and end); 'timed'
        records both and adds the device time between them to the name's
        (``device_ns``, resolved at the next synchronising call)."""
        return _Span(self, name, unit, marks)

    def read(self, value) -> float | list[float]:
        """``float(value)`` (a list of floats for a tensor of more than one
        element), a synchronising call when ``value`` is a tensor."""
        if not isinstance(value, torch.Tensor):
            return float(value)
        with _Wait(self, "read", 1, value.is_cuda):
            return float(value) if value.numel() == 1 else \
                value.reshape(-1).tolist()

    def waits(self, site: str, n: int = 1, idle: bool = True):
        """Count ``n`` synchronising calls of ``site`` inside the block and
        the host time it takes; ``idle``: the device has run dry when the
        block ends (a wait for part of the queued work has not)."""
        return _Wait(self, site, n, idle)

    def invocation(self, kind: str, device):
        return _Invocation(self, kind, device)

    @contextlib.contextmanager
    def quiet(self):
        """No span and no marker inside the block: a step being
        captured."""
        self.capturing = True
        try:
            yield
        finally:
            self.capturing = False

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the captured step's count ``name``
        (``GRAPH_COUNTS``)."""
        self.graph[name] += n

    def snapshot(self) -> tuple:
        """(span totals, synchronising calls, their ns): a copy."""
        return ({k: tuple(v) for k, v in self.totals.items()}, self.syncs,
                self.sync_ns)

    def take_leads(self, name: str) -> list[int]:
        """The smallest leads (ns) of the units of span ``name`` resolved so
        far, in unit order; they leave the recorder."""
        keys = sorted(k for k in self.leads if k[0] == name)
        return [self.leads.pop(k) for k in keys]

    def current(self) -> dict | None:
        """The innermost open invocation's summary, or None."""
        return self.open[-1].summary if self.open else None

    # -- device markers ----------------------------------------------------

    def start_markers(self, device: torch.device) -> None:
        if device != self._device:
            self._pool, self._made, self._cal, self._spare = [], 0, None, None
            self._device = device
        self.stream = torch.cuda.current_stream(device)

    def stop_markers(self) -> None:
        """Markers off; the unresolved ones go back to the pool."""
        self._pool.extend(ev for ev, _, _ in self._pending)
        self._pending.clear()
        self.timed.clear()
        self.stream = None

    def mark(self):
        """Record a marker; its event, or None where none was recorded."""
        if self._cal is None:            # nothing yet to hold it to
            return None
        if self._pool:
            ev = self._pool.pop()
        elif self._made < POOL:
            ev = torch.cuda.Event(enable_timing=True)
            self._made += 1
        else:
            self.drops += 1
            return None
        h = time.time_ns()
        ev.record(self.stream)
        self._pending.append((ev, h, self.unit))
        return ev

    def calibrate(self) -> None:
        """After a wait for the device, whose stream is now idle: put the
        pending markers on the host clock, then record a new calibration
        event."""
        if self._pending and not self._pending[-1][0].query():
            return                       # the device has not reached them
        for first, last, name in self.timed:
            t = self.device_ns.setdefault(name, [0, 0])
            t[0] += 1
            t[1] += round(first.elapsed_time(last) * 1e6)
        self.timed.clear()
        if self._cal is not None:
            cal, h0 = self._cal
            for ev, h, unit in self._pending:
                old = self.leads.get(unit)
                # a unit whose lead reads 0 keeps it: its later markers
                # need no device time
                if unit is not None and old != 0:
                    lead = max(0, h0 + round(cal.elapsed_time(ev) * 1e6) - h)
                    self.leads[unit] = lead if old is None else min(old,
                                                                    lead)
                self._pool.append(ev)
            self._pending.clear()
        new = self._spare or torch.cuda.Event(enable_timing=True)
        self._spare = self._cal[0] if self._cal is not None else None
        h = time.time_ns()
        new.record(self.stream)
        self._cal = (new, h)


RECORDER = Recorder()
span = RECORDER.span
read = RECORDER.read
waits = RECORDER.waits
invocation = RECORDER.invocation


def summaries() -> list[dict]:
    """The kept invocation summaries, oldest first."""
    return list(RECORDER.summaries)


def upload(module, **to):
    """``module.to(**to)``: one synchronising copy a non-empty parameter or
    buffer in host memory."""
    n = sum(1 for t in itertools.chain(module.parameters(), module.buffers())
            if t.numel() and t.device.type == "cpu")
    with waits("upload", n):
        return module.to(**to)


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
        self._last_snap = None
        self._last_graph = None
        self.trace_dir = None if trace_dir is None else Path(trace_dir)
        self.trace_steps = (trace_steps[0] + trace_offset,
                            trace_steps[1] + trace_offset)
        self.trace_cuda = trace_cuda
        self._prof = None
        self._last_device: dict[str, int] = {}

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
        if step % self.log_every != 0:
            return
        if not self.primary:            # no read-back: no interval either
            RECORDER.take_leads("loop.step")
            return
        record = {"step": step}
        with span("loop.readback"):
            record.update({k: read(v) for k, v in metrics.items()})
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
            record.update(self._interval(step))
        else:
            RECORDER.take_leads("loop.step")   # the loop's start
            self._last_snap = RECORDER.snapshot()
            self._last_graph = dict(RECORDER.graph)
            self._last_device = {k: v[1] for k, v in
                                 RECORDER.device_ns.items()}
        self._last_time, self._last_step = now, step
        self._write(record)

    def _interval(self, step: int) -> dict:
        """The recorder's fields of the interval since the last record, per
        step (module docstring); the interval joins the open invocation."""
        (spans, syncs, sync_ns), (spans0, syncs0, sync_ns0) = (
            RECORDER.snapshot(), self._last_snap)
        self._last_snap = (spans, syncs, sync_ns)
        graph0, self._last_graph = self._last_graph, dict(RECORDER.graph)
        graph = {k: v - graph0[k] for k, v in self._last_graph.items()}
        leads = RECORDER.take_leads("loop.step")

        def delta(name, i):
            return spans.get(name, (0,) * 5)[i] - spans0.get(name,
                                                             (0,) * 5)[i]

        steps = delta("loop.step", 0)
        if steps <= 0:
            return {}
        out = {"host_step_ms": delta("loop.step", 1) / 1e6 / steps,
               "sync_wait_ms": (sync_ns - sync_ns0) / 1e6 / steps}
        device = {k: v[1] for k, v in RECORDER.device_ns.items()}
        device0, self._last_device = self._last_device, device
        device_ms = {k: (ns - device0.get(k, 0)) / 1e6
                     for k, ns in device.items() if ns > device0.get(k, 0)}
        if leads:
            out["host_lead_ms"] = statistics.median(leads) / 1e6
        self_ms = {name: delta(name, 2) / 1e6 / steps for name in STEP_SELF
                   if delta(name, 0)}
        out.update({STEP_SELF[n]: v for n, v in self_ms.items()})
        summary = RECORDER.current()
        if summary is not None:
            summary["intervals"].append({
                "step": step, "steps": steps,
                "step_ms": delta("loop.step", 1) / 1e6,
                "syncs": syncs - syncs0, "sync_wait_ms": (sync_ns - sync_ns0)
                / 1e6, "self_ms": {n: v * steps for n, v in self_ms.items()},
                "leads_ms": [x / 1e6 for x in leads],
                "span_ms": {n: delta(n, 1) / 1e6 for n in spans
                            if delta(n, 0)},
                "device_ms": device_ms, **graph})
        return out

    def log_now(self, step: int, metrics: dict) -> None:
        """One record whatever ``log_every`` says (validation results)."""
        if not self.primary:
            return
        self._write({"step": step,
                     **{k: read(v) for k, v in metrics.items()}})

    def _write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        parts = [f"step {record['step']}"] + [
            f"{k}={v:.4g}" for k, v in record.items()
            if k != "step" and not isinstance(v, list)]
        print("  ".join(parts), flush=True)

    def write_json(self, name: str, obj) -> None:
        if not self.primary:
            return
        with open(self.dir / name, "w") as f:
            json.dump(obj, f, indent=2, default=str)
