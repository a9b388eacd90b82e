"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``) names a configuration
(``benchmark/configs``) and a workload file (``benchmark/workloads``),
whose ``kind`` (``benchmark/kinds``) drives the program. ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
(``benchmark/metrics``) and the trace's breakdown. Every run checks the
timed path's output against the plain reference (``benchmark/reference``)
and prints each number compared beside its limit, last on standard error
and under ``checks`` in the result. The last line of standard output is
the result, a JSON object.

Exit codes: 0 with a result; 1 on an error; 2 when the cards the cell
asks for are missing; 3 when a module of the JAX side of the repository
is loaded once the window has closed. Only 0 prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the caches of anything that compiles, at fixed paths in the checkout
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))

from benchmark.harness import check, guard, manifest, stretch  # noqa: E402
from benchmark.harness import trace as T  # noqa: E402


@dataclass
class Ctx:
    """What a traffic kind gets from the harness."""
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config_tree: dict
    workload: dict
    device: object
    card: str
    workdir: Path
    t0: float

    @contextlib.contextmanager
    def reference_precision(self):
        """TF32 off for the reference's float32 products, restored after:
        the program runs with the settings it chose."""
        import torch
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def _program_in_checkout() -> None:
    """The program imported is the one beside this benchmark."""
    import apv_tpu_torch
    where = Path(apv_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise guard.Refusal(f"apv_tpu_torch comes from {where}, outside the "
                            f"checkout {ROOT}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", config_overrides: dict | None = None,
             workload_overrides: dict | None = None,
             t0: float = T_START) -> dict:
    """Run cell ``name`` and return its result (the JSON object). The
    overrides and ``device='cpu'`` serve the tests at small sizes."""
    cell = manifest.cell(name)
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        guard.require_cards(cell["entry"]["chips"])
        card = torch.cuda.get_device_name(dev)
    else:
        card = "cpu"
    _program_in_checkout()
    tree = _merge(cell["config"]["config"], config_overrides or {})
    tree["train"]["seed"] = seed
    work = _merge(cell["workload"], workload_overrides or {})
    workdir = Path(tempfile.mkdtemp(prefix="bench_run_"))
    ctx = Ctx(seed=seed, seconds=seconds, trace=trace, cell=cell,
              config_tree=tree, workload=work, device=dev, card=card,
              workdir=workdir, t0=t0)
    try:
        out = manifest.kind(work["kind"]).run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, checks = check.verdict(out["numbers"], work["limits"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": {
                  "platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": card, "count": cell["entry"]["chips"],
                  "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        s = out["stretch"]
        for spec in cell["per_layer"]:
            value = manifest.reader(spec["name"])(s)
            if value is not None:
                result["metrics"][spec["name"]] = {"value": value,
                                                   "unit": spec["unit"]}
        result["device"].update(busy_s=s.busy_s(), window_s=s.span_s())
        result["breakdown"] = {"device_ops": T.by_name(s.events),
                               "idle_gaps": T.idle_gaps(s.events)}
        # which port kernels the roofline share covers, and which it
        # leaves out and why (also on standard error, in the notes)
        result["roofline_kernels"] = out["notes"]["roofline_kernels"] = (
            stretch.roofline_kernels(s))
        if dev.type == "cuda":
            out["notes"]["card_and_power_limit"] = power_limit()
    else:
        for spec in cell["end_to_end"]:
            result["metrics"][spec["name"]] = {
                "value": out["measured"][spec["name"]], "unit": spec["unit"]}
    result["notes"] = out["notes"]
    result["checks"] = checks
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except guard.Refusal as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    found = guard.forbidden_modules()
    if found:
        print(f"refused: the JAX side is loaded: {found}", file=sys.stderr)
        return 3
    notes = result.pop("notes")
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
