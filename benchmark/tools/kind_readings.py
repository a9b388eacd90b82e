"""The readings that the limits of ``correct`` are set from, for a cell
whose traffic kind brings its own ``readings(ctx, control)`` (the kind
added beside ``train_loop``: ``train_hier``), at the cell's
own sizes, on the card:

    python3 benchmark/tools/kind_readings.py --workload <cell> \
        --seeds 11,12,13 --control 3

For each seed, in one process: the program's numbers against the
reference (its sound runs: the lower readings) and, for the first
``--control`` seeds, the control's (the reference one precision step below
the configuration's, put in the program's place: the upper readings) and
the kind's planted faults'. One JSON line a seed and role on standard
output, as ``tools/readings.py`` prints them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import manifest  # noqa: E402
from benchmark.tools.readings import ctx_for  # noqa: E402


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kind = manifest.kind(manifest.cell(args.workload)["workload"]["kind"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = ctx_for(args.workload, seed, torch.device(args.device))
        try:
            t0 = time.perf_counter()
            for row in kind.readings(ctx, i < args.control):
                print(json.dumps({"cell": args.workload, "seed": seed,
                                  **row}), flush=True)
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
        finally:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
