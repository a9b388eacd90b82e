"""The benchmark's files, found by the names in ``BENCHMARK.json``.

* ``BENCHMARK.json`` at the checkout's root: cells, configurations and
  metrics;
* ``benchmark/configs/<config>.json``: the configuration as it is run
  (``config``, the program's configuration tree), its ``source``,
  ``reduced`` and ``assumed``;
* ``benchmark/workloads/<cell>.json``: the cell's traffic, ``kind`` (a
  module ``benchmark/kinds/<kind>.py``) and its ``params``, and the
  ``limits`` of the numbers that decide ``correct``;
* ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """Everything a run of cell ``name`` reads: the manifest's entry, the
    configuration file, the workload file, and the names of the metrics
    it reports with ``--trace 0`` (``end_to_end``) and ``--trace 1``
    (``per_layer``)."""
    m = manifest()
    entries = {w["name"]: w for w in m["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r}; have {sorted(entries)}")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[entry["config"]]
    work = _json(BENCH / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"],
                                            entry["traffic"]):
        raise ValueError(f"benchmark/workloads/{name}.json names "
                         f"{work['config']}/{work['traffic']}; BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {"entry": entry, "config_entry": cfg_entry,
            "config": _json(ROOT / cfg_entry["file"]), "workload": work,
            "end_to_end": [x for x in m["end_to_end"] if mine(x)],
            "per_layer": [x for x in m["per_layer"] if mine(x)]}


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind(name: str):
    """The module of traffic kind ``name`` (``benchmark/kinds``)."""
    return importlib.import_module(f"benchmark.kinds.{name}")
