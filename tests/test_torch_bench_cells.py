"""The benchmark's VDVAE training cell, ``vdvae_cifar10.train_b128`` (kind
``train_hier``), on the CPU at a small size:

* the cell end to end through ``benchmark/run.py``'s ``run_cell`` at a
  tiny size, untraced and traced: ``correct``, the metrics it reports,
  the port kernels its shapes reckon;
* the planted faults and the control of the kind read above the sound
  run;
* the hierarchical family's work (``harness/hier_counts.py``);
* the recorder's device-timed spans on scripted CUDA events, and the two
  top-down readers on synthetic summaries (None for a program without the
  span).
"""

from __future__ import annotations

import collections
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

import apv_tpu_torch.utils.logging as L

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.harness import hier_counts, manifest  # noqa: E402
from benchmark.harness.stretch import Stretch  # noqa: E402

VDVAE_CELL = "vdvae_cifar10.train_b128"
TINY_VDVAE = {"model": {"widths": [16], "z_dim": 4,
                        "enc_blocks": "8x1,8d2,4x1,4d4,1x1",
                        "dec_blocks": "1x1,4m1,4x1,8m4,8x1",
                        "image_shape": [8, 8, 3], "mix_components": 2},
              "train": {"batch_size": 8, "steps_per_call": 2,
                        "log_every": 4}}
WORK_VDVAE = {"params": {"train_images": 64}}


def test_cells_are_in_the_manifest():
    m = manifest.manifest()
    names = [w["name"] for w in m["workloads"]]
    assert names[-1] == VDVAE_CELL
    c = manifest.cell(VDVAE_CELL)
    assert c["entry"]["chips"] == 1
    assert [x["name"] for x in c["end_to_end"]] == ["train_images_per_s",
                                                    "setup_s"]
    assert all(x["name"].endswith(".train") for x in c["per_layer"])
    topdown = [x["name"] for x in manifest.cell(VDVAE_CELL)["per_layer"]
               if x["name"].startswith("topdown")]
    assert topdown == ["topdown_device_ms_per_step.train",
                       "topdown_host_ms_per_step.train"]
    vd = manifest.cell(VDVAE_CELL)["config"]
    assert vd["reduced"] == [] and vd["config"]["model"]["widths"] == [384]


@pytest.mark.parametrize("cell", [VDVAE_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_cells_run_tiny_on_the_cpu(cell, trace):
    out = harness.run_cell(cell, 2 ** 33 + 5, 0.5, trace, device="cpu",
                           config_overrides=TINY_VDVAE,
                           workload_overrides=WORK_VDVAE)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    limits = manifest.cell(cell)["workload"]["limits"]
    assert set(out["checks"]) == set(limits)
    if not trace:
        assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
        return
    got = set(out["metrics"])
    assert {"step_host_ms.train", "sync_wait_ms_per_step.train",
            "mfu.train", "dispatch_ms_per_step.train"} <= got
    # on the CPU no device marker and no kernel: those read nothing
    assert "topdown_device_ms_per_step.train" not in got
    assert "topdown_host_ms_per_step.train" in got
    assert set(out["roofline_kernels"]["out"]) == {"reparam", "reparam_bwd"}
    assert out["notes"]["parameters"] == 10_692
    assert all(n < 400 for n in out["notes"]["checked_grad_norms"])


@pytest.mark.parametrize("cell", [VDVAE_CELL])
def test_faults_and_control_read_above_the_sound_run(cell):
    from benchmark.tools.readings import ctx_for
    ctx = ctx_for(cell, 2 ** 32 + 7, torch.device("cpu"))
    ctx.config_tree = harness._merge(ctx.config_tree, TINY_VDVAE)
    ctx.workload = harness._merge(ctx.workload, WORK_VDVAE)
    rows = {r["role"]: r for r in
            manifest.kind(ctx.workload["kind"]).readings(ctx, True)}
    sound = rows.pop("program")
    assert set(rows) >= {"control", "fault_half_batch",
                         "fault_state_unchanged"}
    keys = [k for k in sound if k.endswith("_gap") and k != "loss_gap"]
    for role, r in rows.items():
        # each stand-in reads worse than the sound run in some number
        assert any(r[k] > max(2 * sound[k], 1e-6) for k in keys), (role, r,
                                                                    sound)
    assert rows["fault_state_unchanged"]["change_gap"] == pytest.approx(1.0)


def test_hier_counts_at_the_cell_size():
    tree = manifest.cell(VDVAE_CELL)["config"]["config"]
    per = hier_counts.step_kernels(tree["model"], 128)
    assert per["reparam"]["launches"] == per["reparam_bwd"]["launches"] == 43
    n = sum(128 * 16 * r * r for r, _ in hier_counts.vdvae.parse_blocks(
        tree["model"]["dec_blocks"]))
    assert per["reparam"]["bytes"] == 4 * (5 * n + 43 * 128)
    assert per["reparam_bwd"]["bytes"] == 4 * (10 * n + 43 * 128)
    flops = hier_counts.train_flops_per_image(tree)
    assert 1.2e11 < flops < 1.8e11         # ~45 GFLOP forward, 3× trained


def test_timed_span_device_time_on_scripted_events(monkeypatch):
    """Markers of a 'timed' span at device 5100 and 5700 (ns) add 600 ns to
    its name once a calibration resolves them; a 'both' span's add
    nothing."""
    from test_torch_spans import _FakeClock, _FakeEvent
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    # host ns: calibration, each span's start, markers and end, calibration
    monkeypatch.setattr(L, "time", _FakeClock(
        [1000, 1100, 1150, 1200, 1250, 1300, 1350, 1400, 1450, 2000]))
    _FakeEvent.times = collections.deque(
        [5000, 5100, 5700, 5800, 5900, 6000])
    rec = L.Recorder()
    rec.start_markers(torch.device("cuda"))
    rec.calibrate()
    monkeypatch.setattr(L, "_traced", lambda: False)
    with rec.span("model.topdown", marks="timed"):
        pass
    with rec.span("model.encoder", marks="both"):
        pass
    assert len(rec.timed) == 1
    rec.calibrate()
    assert rec.device_ns == {"model.topdown": [1, 600]}
    assert rec.timed == []


def _train(profiled, intervals):
    return {"kind": "train_loop", "profiled": profiled,
            "intervals": intervals}


def _interval(steps, topdown_host=None, topdown_device=None):
    i = {"steps": steps, "step_ms": 10.0 * steps, "sync_wait_ms": 0.0,
         "leads_ms": []}
    if topdown_host is not None:
        i["span_ms"] = {"model.topdown": topdown_host, "loop.step": 1.0}
        i["device_ms"] = {"model.topdown": topdown_device}
    return i


@pytest.mark.parametrize("name,want", [
    ("topdown_device_ms_per_step.train", 6.0),     # median of 4, 6, 9
    ("topdown_host_ms_per_step.train", 3.0)])      # median of 2, 3, 5
def test_topdown_readers_on_synthetic_summaries(monkeypatch, name, want):
    spec = importlib.util.spec_from_file_location(
        "reader", ROOT / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kept = [_train(False, [_interval(2, 0.0, 0.0),        # the loop's start
                           _interval(2, 4.0, 8.0), _interval(4, 12.0, 24.0),
                           _interval(2, 10.0, 18.0)]),
            _train(True, [_interval(2, 99.0, 99.0)])]
    monkeypatch.setattr(L.RECORDER, "summaries", collections.deque(kept))
    s = Stretch(unit="train", events=[])
    assert module.read(s) == pytest.approx(want)
    assert module.read(Stretch(unit="iwae", events=[])) is None
    # a program without the span (the parent's) reads nothing
    plain = [_train(False, [_interval(2)] * 3), _train(True, [_interval(2)])]
    monkeypatch.setattr(L.RECORDER, "summaries", collections.deque(plain))
    assert module.read(s) is None


def test_vector_metric_read_and_record(tmp_path, capsys):
    logger = L.MetricLogger(tmp_path, log_every=1)
    logger.log(0, {"loss": torch.tensor(1.5),
                   "kl_layers": torch.tensor([1.0, 2.0, 3.0])})
    line = (tmp_path / "metrics.jsonl").read_text().splitlines()[-1]
    assert '"kl_layers": [1.0, 2.0, 3.0]' in line
    printed = capsys.readouterr().out
    assert "loss=1.5" in printed and "kl_layers" not in printed
    assert math.isclose(L.read(torch.tensor([2.5])), 2.5)
