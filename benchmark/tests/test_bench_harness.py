"""The manifest and the files it names, the trace arithmetic, the tap and
the import check."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT

from benchmark.harness import check, guard, manifest, tap, trace
from benchmark.harness.stretch import Stretch, idle_share

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def m():
    return manifest.manifest()


def test_manifest_keys_and_names(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in m["end_to_end"] + m["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert 1 <= len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    assert [w["name"] for w in m["workloads"]] == list(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in m["workloads"]} == {c["name"] for c in
                                                     m["configs"]}
    assert len(json.dumps(m)) <= 64 * 1024


def test_metrics_keys_bounds_and_sources(m):
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
    setup = {x["name"]: x for x in m["end_to_end"]}["setup_s"]
    assert "workloads" not in setup
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{x['name']}.py").exists()
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_its_metrics_need(m, name):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one; a per-layer metric's ``moves`` is reported by every
    cell that reports the metric."""
    c = manifest.cell(name)
    e2e = {x["name"] for x in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for x in c["per_layer"]:
        assert x["moves"] in e2e, (name, x["name"])
    cfg = c["config"]
    assert cfg["name"] == c["entry"]["config"]
    assert cfg["source"] == c["config_entry"]["source"]
    assert cfg["reduced"] == c["config_entry"]["reduced"] == []
    assert set(c["workload"]["limits"]) and all(
        v is not None and v > 0 for v in c["workload"]["limits"].values())
    assert manifest.kind(c["workload"]["kind"]).run


def test_configs_are_the_presets_as_run():
    """Each configuration file holds its preset, untouched (nothing is
    reduced)."""
    import dataclasses
    from apv_tpu_torch.utils.config import get_preset
    for c in manifest.manifest()["configs"]:
        held = json.loads((ROOT / c["file"]).read_text())["config"]
        preset = json.loads(json.dumps(dataclasses.asdict(
            get_preset(c["name"]))))
        assert held == preset, c["name"]


def test_union_of_intervals_on_a_synthetic_trace():
    ev = [trace.Event("host", "cpu_op", 0.0, 100.0),
          trace.Event("aten::item", "cpu_op", 60.0, 90.0),
          trace.Event("cudaStreamSynchronize", "cuda_runtime", 65.0, 85.0),
          trace.Event("k1", "kernel", 10.0, 30.0),
          trace.Event("k2", "kernel", 20.0, 40.0),      # overlaps k1
          trace.Event("copy", "gpu_memcpy", 50.0, 60.0),
          trace.Event("k3", "kernel", 55.0, 58.0)]      # inside the copy
    assert trace.busy_us(ev) == pytest.approx(40.0)     # 10-40, 50-60
    assert trace.span_us(ev) == (0.0, 100.0)
    assert trace.blocked_us(ev) == pytest.approx(20.0)
    s = Stretch(unit="train", events=ev, steps=2)
    assert idle_share(s, "train") == pytest.approx(60.0)
    assert idle_share(s, "iwae") is None
    gaps = dict(trace.idle_gaps(ev))
    # 0-10 and 40-50 under "host", 60-100 under "aten::item" from 60
    assert gaps["host"] == pytest.approx(20e-6)
    assert gaps["aten::item"] == pytest.approx(40e-6)
    top = trace.by_name(ev)
    assert top[0] == ["k1", 20e-6] or top[0][1] == pytest.approx(20e-6)


def test_trace_file_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void a::reparam_samples<64>()",
         "ts": 5, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 10},
        {"ph": "i", "cat": "marker", "name": "x", "ts": 3}]}))
    ev = trace.load(path)
    assert len(ev) == 2
    assert trace.kernel_calls(ev, "reparam_samples") == (1, 2.0)
    assert trace.kernel_calls(ev, "reparam_bwd_sum") == (0, 0.0)


def test_tap_takes_the_clock_at_records():
    with tap.RecordTap() as t:
        print("step 100  loss=1.0")
        print("something else")
        print("step 200  loss=2.0")
    assert [s for _, s in t.records] == [100, 200]
    assert t.records[0][0] <= t.records[1][0]
    assert len(t.lines) == 3


def test_verdict_and_leaf_gaps():
    ok, checks = check.verdict({"a": 1.0, "b": 0.5}, {"a": 2.0, "b": 1.0})
    assert ok and checks["a"] == {"value": 1.0, "limit": 2.0}
    assert not check.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.verdict({"a": 1.0}, {})[0]
    ref = {("g", "a"): 1.0, ("g", "b"): 2.0, ("g", "c"): 1e-9}
    prog = {("g", "a"): 1.1, ("g", "b"): 2.0, ("g", "c"): 0.0}
    gap, leaf = check.leaf_gaps(prog, ref)
    assert leaf == ("g", "a") and gap == pytest.approx(0.1)
    assert check.negligible(ref) == {("g", "c")}
    assert check.leaf_gaps({}, ref)[0] == float("inf")


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["apv_tpu_torch", "apv_tpu_torch.ops", "jaxtyping", "flaxen",
            "apv_tpu", "apv_tpu.core", "jax.numpy", "optax", "orbax.x"]
    assert guard.forbidden_modules(mods) == ["apv_tpu", "apv_tpu.core",
                                             "jax.numpy", "optax", "orbax.x"]


def test_a_run_loads_no_jax_side_module():
    """A small run of every cell on the CPU, in a fresh process, leaves
    nothing of the JAX side in ``sys.modules``."""
    code = ("import json, sys; sys.path.insert(0, %r); sys.path.insert(0, "
            "%r); from conftest import TINY, TINY_WORK, CELLS; "
            "from benchmark.run import run_cell; "
            "from benchmark.harness import guard, manifest\n"
            "for c in CELLS:\n"
            "    k = manifest.cell(c)['workload']['kind']\n"
            "    r = run_cell(c, 5, 0.2, False, device='cpu', "
            "config_overrides=TINY, workload_overrides=TINY_WORK[k])\n"
            "print(json.dumps(guard.forbidden_modules()))"
            % (str(ROOT), str(ROOT / "benchmark" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits nonzero and prints no
    result."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         CELLS[1], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
