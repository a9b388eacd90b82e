"""The span recorder of ``apv_tpu_torch/utils/logging.py``: spans and their
self time, the counter of synchronising calls, the device markers' host
lead, the invocation summaries and their benchmark readers, the clock
shared with the profiler's Chrome trace, and the recorder's silence under
``torch.export`` and fx.

The CPU tests run in the tier-1 suite. The tests marked ``card`` need a
CUDA card and skip without one; this file imports no JAX, so on the card's
machine they run without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \
        tests/test_torch_spans.py
"""

from __future__ import annotations

import collections
import json
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch.utils import logging as L
from apv_tpu_torch.utils.config import apply_overrides, get_preset

TINY = ["model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[16,16]", "train.batch_size=8",
        "train.steps_per_call=2", "train.log_every=2", "train.eval_every=4",
        "train.checkpoint_every=4", "data.synthetic_size=64",
        "eval.iwae_k=4", "eval.iwae_chunk=2", "eval.batch_size=4"]
STEP_FIELDS = ("host_step_ms", "sync_wait_ms", "g_phase_self_ms",
               "d_phase_self_ms", "g_opt_self_ms", "d_opt_self_ms")


@pytest.fixture(autouse=True)
def fresh_recorder():
    L.RECORDER.reset()
    yield
    L.RECORDER.reset()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the device markers and the sync debug "
                    "mode exist only there")
    return torch.device("cuda")


def _cfg(tmp_path, *extra):
    return apply_overrides(get_preset("cifar_advprior_resnet"),
                           TINY + [f"results_dir={tmp_path}", *extra])


def _records(cfg) -> list[dict]:
    path = Path(cfg.results_dir) / cfg.name / "metrics.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines() if x]


def _host_tensors(module) -> int:
    return sum(1 for t in list(module.parameters()) + list(module.buffers())
               if t.numel())


def _storages(state) -> int:
    sd = state.state_dict()
    ts = [*sd["model"].values(), *sd["d"].values(), *sd["opt"]["mu"],
          *sd["opt"]["nu"], *sd["d_opt"]["mu"], *sd["d_opt"]["nu"]]
    return len({t.untyped_storage().data_ptr() for t in ts if t.numel()})


def test_nesting_and_self_time():
    rec = L.Recorder()
    with rec.span("outer"):
        time.sleep(0.002)
        with rec.span("inner"):
            time.sleep(0.002)
        with rec.span("inner"):
            pass
    (c_o, ns_o, self_o, s_o, e_o) = rec.totals["outer"]
    (c_i, ns_i, self_i, s_i, e_i) = rec.totals["inner"]
    assert (c_o, c_i) == (1, 2)
    assert self_o == ns_o - ns_i and self_i == ns_i
    assert ns_o == e_o - s_o and s_o <= s_i <= e_i <= e_o
    assert self_o >= 2_000_000 and ns_i >= 2_000_000
    assert rec.stack == [] and rec.unit is None


def test_units_nest_and_restore():
    rec = L.Recorder()
    with rec.span("eval.batch", unit=3):
        assert rec.unit == ("eval.batch", 3)
        with rec.span("eval.chunk"):
            assert rec.unit == ("eval.batch", 3)
    assert rec.unit is None


def test_read_and_waits_count_sites():
    rec = L.Recorder()
    assert rec.read(1.5) == 1.5                      # a number: no site
    assert rec.read(torch.tensor(2.0)) == 2.0
    with rec.waits("upload", 3):
        pass
    assert rec.syncs == 4 and rec.sites["read"][0] == 1
    assert rec.sites["upload"][0] == 3 and rec.sync_ns >= 0


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []

    class Spy:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    with L.span("quiet"):
        pass
    assert opened == [] and L.RECORDER.profiled == 0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with L.span("traced"):
            pass
    assert opened == ["traced"] and L.RECORDER.profiled == 1


class _Probe(torch.nn.Module):
    def forward(self, x):
        with L.span("probe", marks="start"):
            y = x * 2.0
        with L.waits("probe_wait"):
            y = y + 1.0
        return y


def test_silent_under_torch_export_and_fx():
    """Under tracing the recorder counts nothing and opens no profiler
    range, even while a profiler runs: the traced graph is as without it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(3, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        ep = torch.export.export(_Probe(), (x,), strict=False)
        gm = torch.fx.symbolic_trace(_Probe())
    assert "probe" not in L.RECORDER.totals and L.RECORDER.syncs == 0
    for graph in (ep.graph, gm.graph):
        targets = [str(n.target) for n in graph.nodes]
        assert not any("profiler" in t or "record_function" in t
                       for t in targets), targets
    torch.testing.assert_close(ep.module()(x), x * 2.0 + 1.0)
    with L.span("probe"):
        pass
    assert L.RECORDER.totals["probe"][0] == 1


class _FakeEvent:
    """A CUDA timing event on a scripted device clock: ``record`` takes the
    next device time of ``_FakeEvent.times`` (ns); ``timed`` counts the
    ``elapsed_time`` calls."""
    times: collections.deque = collections.deque()
    timed = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.times.popleft()

    def query(self):
        return True

    def elapsed_time(self, other):
        _FakeEvent.timed += 1
        return (other.t - self.t) / 1e6


class _FakeClock:
    def __init__(self, times):
        self.times = collections.deque(times)

    def time_ns(self):
        return self.times.popleft()


def test_host_lead_from_markers_and_calibration(monkeypatch):
    """Leads on scripted host and device clocks (ns). Calibrated at host
    1000, device 5000 (idle there). Step 0's markers, enqueued at host
    1100, 1200, 1300, are reached at device 5100, 5700, 5800: leads 0,
    500, 500, so the step's is 0. A pool of three drops step 1's first
    marker. Calibrated again at host 2000 (device 6000), the pool back;
    step 1's next marker, enqueued at host 2100 and reached at device
    7600, leads by 1500."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(L, "POOL", 3)
    monkeypatch.setattr(L, "time", _FakeClock(
        [1000, 1100, 1200, 1300, 2000, 2100, 3000]))
    _FakeEvent.times = collections.deque(
        [5000, 5100, 5700, 5800, 6000, 7600, 8000])
    rec = L.Recorder()
    rec.start_markers(torch.device("cuda"))
    rec.calibrate()
    rec.unit = ("loop.step", 0)
    for _ in range(3):
        rec.mark()
    rec.unit = ("loop.step", 1)
    rec.mark()                              # the pool of 3 is spent
    assert rec.drops == 1 and len(rec._pending) == 3
    rec.calibrate()
    assert rec.leads == {("loop.step", 0): 0}
    assert rec._cal[1] == 2000 and len(rec._pool) == 3
    rec.mark()
    rec.calibrate()
    assert rec.take_leads("loop.step") == [0, 1500] and rec.leads == {}
    rec.stop_markers()
    assert rec.stream is None and rec._pending == []


def test_a_unit_at_lead_zero_times_no_more_markers(monkeypatch):
    """Step 0's first marker finds the device idle (lead 0): its other two
    are not timed; step 1's are, its smallest lead 300."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(L, "time", _FakeClock(
        [1000, 1100, 1200, 1300, 1400, 1500, 1600, 3000]))
    _FakeEvent.times = collections.deque(
        [5000, 5100, 5200, 5300, 5700, 6800, 6900, 9000])
    _FakeEvent.timed = 0
    rec = L.Recorder()
    rec.start_markers(torch.device("cuda"))
    rec.calibrate()
    for step in (0, 1):
        rec.unit = ("loop.step", step)
        for _ in range(3):
            rec.mark()
    rec.calibrate()
    assert rec.take_leads("loop.step") == [0, 300]
    assert _FakeEvent.timed == 4


def test_lead_is_device_reach_less_enqueue(monkeypatch):
    """One marker: calibration event recorded at host h0 = 10 ms, reached
    at device clock 50 ms; a marker enqueued at host 12 ms reached at
    device clock 55 ms is reached at host 15 ms: a lead of 3 ms."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    rec = L.Recorder()
    rec.start_markers(torch.device("cuda"))
    _FakeEvent.times = collections.deque([50_000_000, 55_000_000,
                                          60_000_000])
    monkeypatch.setattr(L, "time", _FakeClock([10_000_000, 12_000_000,
                                               20_000_000]))
    rec.calibrate()
    rec.unit = ("eval.batch", 0)
    rec.mark()
    rec.calibrate()
    assert rec.take_leads("eval.batch") == [3_000_000]


def test_train_loop_spans_syncs_and_records(tmp_path):
    """A tiny CPU ``train_loop``: a ``loop.step`` span a step, a
    ``loop.readback`` a logged record, and a synchronising call at every
    site it passes: each upload of a host tensor (the VAE's and D's
    parameters and buffers, the resident train set, each valid batch),
    each tensor read back (the logged metrics, β among them: a device
    number of the step's block; three a valid batch) and each storage a
    checkpoint save copies."""
    from apv_tpu_torch.training.loop import load_train_arrays, train_loop
    cfg = _cfg(tmp_path)
    state = train_loop(cfg, max_steps=8, device="cpu")
    (summary,) = L.summaries()
    spans = summary["spans"]
    records = _records(cfg)
    logged = [r for r in records if "loss" in r]
    valid = [r for r in records if "valid_elbo" in r]
    assert spans["loop.step"]["count"] == 8
    assert spans["loop.data"]["count"] == 4                  # calls of 2
    assert spans["loop.readback"]["count"] == len(logged) == 4
    assert spans["step.g_phase"]["count"] == spans["step.d_phase"]["count"] \
        == spans["step.g_opt"]["count"] == spans["step.d_opt"]["count"] == 8
    assert spans["loop.validate"]["count"] == len(valid) == 2
    assert spans["loop.step"]["self_ms"] < spans["loop.step"]["ms"]
    _, valid_arrays = load_train_arrays(cfg)
    n_valid = len(valid_arrays["image"])
    valid_batches = n_valid // min(cfg.train.batch_size, n_valid)
    reads = sum(len(r) - 1 for r in logged[:1]) * len(logged)  # but step
    assert summary["sync_sites"] == {
        "upload": (_host_tensors(state.model) + _host_tensors(state.d)
                   + int(cfg.data.device_resident) + valid_batches),
        "read": reads + 3 * valid_batches * len(valid),
        "save": spans["loop.save"]["count"] * _storages(state)}
    assert summary["syncs"] == sum(summary["sync_sites"].values())
    assert summary["profiled"] is False and summary["drops"] == 0
    # records after the first carry the recorder's fields, per step
    assert [iv["step"] for iv in summary["intervals"]] == [2, 4, 6]
    for r in logged[1:]:
        assert set(STEP_FIELDS) <= set(r) and "host_lead_ms" not in r
        assert 0 < r["host_step_ms"] and r["g_phase_self_ms"] > 0
    assert not set(STEP_FIELDS) & set(logged[0])
    for iv in summary["intervals"]:
        assert iv["steps"] == 2 and iv["leads_ms"] == []
    assert sum(iv["syncs"] for iv in summary["intervals"]) < \
        summary["syncs"]


def test_evaluate_nll_spans_and_syncs(tmp_path):
    """A tiny CPU ``evaluate_nll`` under the adversarial prior: an
    ``eval.batch`` a batch, k/chunk ``eval.chunk`` a batch, one
    ``eval.log_partition`` and one ``eval.readback``; synchronising calls
    at each upload (the host tensors of the VAE and D, two a batch and the
    count of each batch's estimate) and three reads (the scores, log Z and
    its error)."""
    from apv_tpu_torch.eval.run import evaluate_nll
    from apv_tpu_torch.models import build_model, make_latent_d
    cfg = _cfg(tmp_path)
    model = build_model(cfg.model, device="cpu")
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device="cpu")
    L.RECORDER.reset()
    images = np.random.default_rng(0).integers(0, 256, (14, 32, 32, 3),
                                                 dtype=np.uint8)
    out = evaluate_nll(cfg, model, d, images, device="cpu")
    (summary,) = L.summaries()
    batches = 14 // cfg.eval.batch_size
    spans = summary["spans"]
    assert summary["kind"] == "evaluate_nll"
    assert summary["images"] == out["num_examples"] == 12
    assert spans["eval.batch"]["count"] == batches
    assert spans["eval.chunk"]["count"] == batches * (
        cfg.eval.iwae_k // cfg.eval.iwae_chunk)
    assert spans["eval.log_partition"]["count"] == \
        spans["eval.readback"]["count"] == 1
    assert summary["sync_sites"] == {
        "upload": _host_tensors(model) + _host_tensors(d) + 3 * batches,
        "read": 3}
    assert summary["unit_leads_ms"] == {}


def _last_events(path) -> tuple[dict, int]:
    raw = json.loads(Path(path).read_text())
    last = {}
    for e in raw["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            if e["name"] not in last or e["ts"] > last[e["name"]]["ts"]:
                last[e["name"]] = e
    return last, int(raw.get("baseTimeNanoseconds", 0))


def _shared_clock(tmp_path, device):
    """A loop that ends inside its profiler window (steps 10-15, calls of
    one step): the trace holds the spans' ``user_annotation`` events, and
    the last one of each name starts and ends within 0.1 ms of where the
    recorder has it, on ``time.time_ns()``'s clock."""
    from apv_tpu_torch.training.loop import train_loop
    cfg = _cfg(tmp_path, "train.steps_per_call=1", "train.eval_every=0",
               "train.checkpoint_every=100")
    train_loop(cfg, max_steps=12, device=device,
               trace_dir=str(tmp_path / "trace"))
    (summary,) = L.summaries()
    assert summary["profiled"] is True
    (path,) = sorted((tmp_path / "trace").glob("*.json"))
    last, base = _last_events(path)
    names = ("loop.data", "loop.step", "loop.readback", "loop.save",
             "step.g_phase", "step.d_phase", "step.g_opt", "step.d_opt")
    assert set(names) <= set(last), sorted(last)
    for name in names:
        e = last[name]
        start, end = L.RECORDER.totals[name][3:]
        t0 = base + round(e["ts"] * 1e3)
        t1 = base + round((e["ts"] + e["dur"]) * 1e3)
        assert abs(t0 - start) < 100_000, (name, t0 - start)
        assert abs(t1 - end) < 100_000, (name, t1 - end)


def test_recorder_shares_the_profilers_clock(tmp_path):
    _shared_clock(tmp_path, "cpu")


def _train_summary(profiled, intervals):
    return {"kind": "train_loop", "profiled": profiled,
            "intervals": intervals, "spans": {}, "syncs": 0,
            "unit_leads_ms": {}}


def _eval_summary(profiled, syncs, images, leads):
    return {"kind": "evaluate_nll", "profiled": profiled, "intervals": [],
            "syncs": syncs, "images": images,
            "unit_leads_ms": {"eval.batch": leads}}


def _interval(steps, step_ms, sync_ms, leads):
    return {"steps": steps, "step_ms": step_ms, "sync_wait_ms": sync_ms,
            "leads_ms": leads, "syncs": 1, "self_ms": {}}


READERS = ("step_host_ms.train", "sync_wait_ms_per_step.train",
           "host_lead_ms.train", "host_lead_ms.iwae", "syncs_per_image.iwae")


@pytest.mark.parametrize("name", READERS)
def test_readers_anchor_on_the_profiled_invocation(name, monkeypatch):
    """The train readers take the unprofiled ``train_loop`` just before the
    newest profiled one, less its first interval; the IWAE readers the
    unprofiled ``evaluate_nll`` calls back to the profiled one before, less
    the oldest. Nothing to read gives None."""
    from benchmark.harness import manifest
    from benchmark.harness.stretch import Stretch
    unit = name.rsplit(".", 1)[1]
    read = manifest.reader(name)
    s = Stretch(unit=unit, events=[])
    assert read(s) is None
    kept = [
        _train_summary(False, [_interval(4, 400.0, 9.0, [90.0])] * 3),
        _eval_summary(True, 99, 1, [99.0]),
        _eval_summary(False, 50, 64, [50.0]),          # the oldest: out
        _train_summary(False, [_interval(2, 900.0, 9.0, [9.0]),
                               _interval(4, 40.0, 1.0, [1.0, 3.0]),
                               _interval(2, 30.0, 0.5, [2.0]),
                               _interval(2, 36.0, 0.5, [])]),
        _eval_summary(False, 3, 64, [4.0, 6.0]),
        _eval_summary(False, 5, 64, [1.0]),
        _train_summary(True, [_interval(2, 80.0, 8.0, [0.0])] * 2),
        _eval_summary(True, 99, 64, [99.0]),
    ]
    monkeypatch.setattr(L.RECORDER, "summaries", collections.deque(kept))
    want = {"step_host_ms.train": 15.0,             # median of 10, 15, 18
            "sync_wait_ms_per_step.train": 2.0 / 8,
            "host_lead_ms.train": 2.0,
            "host_lead_ms.iwae": 4.0,
            "syncs_per_image.iwae": 8 / 128}[name]
    assert read(s) == pytest.approx(want)
    other = Stretch(unit="iwae" if unit == "train" else "train", events=[])
    assert read(other) is None
    monkeypatch.setattr(L.RECORDER, "summaries", collections.deque(
        s_ for s_ in kept if not s_["profiled"]))
    assert read(s) is None                          # no profiled anchor


# -- on the card -------------------------------------------------------------

def _sync_warnings(fn) -> list[tuple[str, list[str]]]:
    """Run ``fn`` under ``set_sync_debug_mode("warn")``: each synchronising
    call torch reports, as (file:line, the last frames of its stack)."""
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[-9:-3]
            seen.append((f"{Path(filename).name}:{lineno}",
                         [f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                          for f in stack]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen


@pytest.mark.card
def test_card_counter_equals_the_sync_debug_mode(card, tmp_path):
    """One ``train_loop`` call (init, resident train set, validation, saves)
    and one ``evaluate_nll`` call under ``set_sync_debug_mode("warn")``:
    every synchronising call torch reports is one the counter counts."""
    from apv_tpu_torch.eval.run import evaluate_nll
    from apv_tpu_torch.training.loop import train_loop
    cfg = _cfg(tmp_path)
    images = np.random.default_rng(0).integers(0, 256, (12, 32, 32, 3),
                                                 dtype=np.uint8)
    state = train_loop(cfg, max_steps=2, device=card)   # builds the kernels
    torch.cuda.synchronize()
    calls = {"train_loop": lambda: train_loop(_cfg(tmp_path / "t"),
                                              max_steps=8, device=card),
             "evaluate_nll": lambda: evaluate_nll(cfg, state.model, state.d,
                                                  images, device=card)}
    got = {}
    for what, fn in calls.items():
        before = (L.RECORDER.syncs, {k: v[0] for k, v in
                                     L.RECORDER.sites.items()})
        seen = _sync_warnings(fn)
        torch.cuda.synchronize()
        stacks = {}
        for where, stack in seen:
            stacks.setdefault(where, stack)
        got[what] = {
            "torch": len(seen), "counted": L.RECORDER.syncs - before[0],
            "where": dict(collections.Counter(w for w, _ in seen)),
            "sites": {k: v[0] - before[1].get(k, 0)
                      for k, v in L.RECORDER.sites.items()
                      if v[0] != before[1].get(k, 0)},
            "stacks": stacks}
    print(json.dumps({"sync_debug": got}))
    for what, g in got.items():
        assert g["torch"] == g["counted"], (what, g)


@pytest.mark.card
@pytest.mark.parametrize("bound", ["host", "device"])
def test_card_host_lead_tells_who_sets_the_pace(card, tmp_path, bound):
    """Steps that sleep on the host and give the card a few microseconds
    of work read a lead near 0; steps of sixteen bf16 products at 4096
    (~2 ms of device work) that the host enqueues in microseconds lead by
    ~2 ms more each step after a read-back, ~15 ms at the median."""
    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    x = torch.randn(8, 8, device=card)
    logger = L.MetricLogger(tmp_path, log_every=10)
    with L.invocation("train_loop", card):
        L.read(x.sum())                      # an idle point to start from
        for step in range(31):
            with L.span("loop.step", unit=step, marks="both"):
                if bound == "host":
                    time.sleep(0.003)
                    y = x * 2.0
                else:
                    y = a
                    for _ in range(16):
                        y = y @ a
                    y = y[:8, :8].float()
            logger.log(step, {"y": y.sum()})
    (summary,) = L.summaries()
    leads = [x_ for iv in summary["intervals"] for x_ in iv["leads_ms"]]
    assert len(leads) == 30 and summary["drops"] == 0
    lead = float(np.median(leads))
    print(json.dumps({"bound": bound, "host_lead_ms": lead}))
    if bound == "host":
        assert lead < 0.5, leads
    else:
        assert lead > 2.0, leads


@pytest.mark.card
def test_card_recorder_shares_the_profilers_clock(card, tmp_path):
    _shared_clock(tmp_path, card)
