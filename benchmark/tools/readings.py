"""The readings that the limits of ``correct`` are set from, at a cell's
own sizes, on the card:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 11,12,13 \
        --control 3

For each seed, in one process: the program's numbers against the
reference (its sound runs: the lower readings), and for the first
``--control`` seeds the control's (the reference one precision step below
the configuration's, put in the program's place: the upper readings) and,
for a training cell, the planted faults' (the reference put in the
program's place with half of each batch, the mean taken over that half;
with a state left unchanged; with G's gradient lacking the KL's, or
D(z)'s: ``reference.train.follow``). One JSON line a seed and role on
standard output.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402
from benchmark.harness import manifest  # noqa: E402
from benchmark.reference.models import Precision  # noqa: E402
from benchmark.reference.train import FAULTS  # noqa: E402


def ctx_for(name: str, seed: int, device) -> harness.Ctx:
    cell = manifest.cell(name)
    tree = harness._merge(cell["config"]["config"], {})
    tree["train"]["seed"] = seed
    return harness.Ctx(seed=seed, seconds=0.0, trace=False, cell=cell,
                       config_tree=tree, workload=cell["workload"],
                       device=device, card="", t0=time.perf_counter(),
                       workdir=Path(tempfile.mkdtemp(prefix="bench_rd_")))


def train_readings(ctx, control: bool) -> list[dict]:
    from benchmark.kinds import train_loop as kind
    prep = kind.Prepared(ctx)
    prog = prep.checked_steps()
    with ctx.reference_precision():
        ref = prep.reference()
        rows = [("program", prog)]
        if control:
            rows.append(("control", prep.reference(Precision("control"))))
            half = ctx.config_tree["train"]["batch_size"] // 2
            rows.append(("fault_half_batch", prep.reference(rows=half)))
            rows += [(f"fault_{f}", prep.reference(fault=f))
                     for f in FAULTS]
    return [{"role": role, **kind.compare(got, ref)["numbers"]}
            for role, got in rows]


def iwae_readings(ctx, control: bool) -> list[dict]:
    from benchmark.kinds import evaluate_nll as kind
    prep = kind.Prepared(ctx)
    p = ctx.workload["params"]
    # the window's calls at the cell's load, two batches' worth at least
    n = max(2 * prep.batch, prep.one) // prep.one
    calls = ([(0, n * prep.one, prep.seed0)] if p["call_batches"] is None
             else kind._calls(p, p["test_images"], prep.batch, n,
                              prep.seed0))
    results = [prep.call(*c) for c in calls]
    prep.release()
    picks = kind.pick_rows(ctx.seed, calls, p["check_images"])
    prog = kind.program_scores(calls, results, picks)
    with ctx.reference_precision():
        ref = kind.reference_scores(prep, calls, picks, Precision())
        stated = kind.reference_scores(prep, calls, picks,
                                       Precision("stated"))
        rows = [("program", prog)]
        if control:
            rows.append(("control", kind.reference_scores(
                prep, calls, picks, Precision("control"))))
    out = [{"role": role, **kind.gaps(got, ref, stated)}
           for role, got in rows]
    # each checked image: reference, program, stated and (control) scores
    out.append({"role": "scores", "rows": [
        [ref[0][key], prog[0][key], stated[0][key]]
        + ([rows[1][1][0][key]] if control else [])
        for key in sorted(ref[0])]})
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kind = manifest.cell(args.workload)["workload"]["kind"]
    read = train_readings if kind == "train_loop" else iwae_readings
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = ctx_for(args.workload, seed, torch.device(args.device))
        try:
            t0 = time.perf_counter()
            for row in read(ctx, i < args.control):
                print(json.dumps({"cell": args.workload, "seed": seed,
                                  **row}), flush=True)
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
        finally:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
