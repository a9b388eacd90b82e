"""Two checkouts of the port's training loop and IWAE evaluation, timed
side by side on one CUDA card.

    python3 loop_ab.py --parent DIR [--pairs 10]

DIR is another checkout of this repository (for example ``git archive``
of an earlier commit, unpacked into a directory that ``.gitignore``
lists). Each sample is a fresh process (``python3 -P`` with one checkout
on ``PYTHONPATH``, so each imports its own ``apv_tpu_torch`` and builds
its own kernels) that, on seeded synthetic CIFAR images at the flagship's
full width (``cifar_advprior_resnet``, batch 256, ``steps_per_call=8``):

* runs ``train_loop`` for 16 steps to warm up, then a timed run of 48
  steps that logs every 8 (one read-back a call, no validation), as
  ``chip_smoke.py``'s ``cifar_train`` timing does: ``step_ms`` is the
  mean of the logger's ``step_time_s``;
* scores 1,024 images with ``evaluate_nll`` at k=100, chunk 25, batch 64
  (the OOD phase's estimator) after a warm-up call: ``eval_s`` is the
  wall of the second call, the card synchronized.

The pairs alternate which checkout runs first. One JSON line a sample,
then for each metric the medians, the quartiles, and the count of pairs
the change wins; the ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WARM_STEPS, TIMED_STEPS, LOG_EVERY = 16, 48, 8
EVAL_IMAGES, EVAL_K, EVAL_CHUNK, EVAL_BATCH = 1024, 100, 25, 64


def child() -> None:
    """One sample, in the checkout that ``PYTHONPATH`` names."""
    import numpy as np
    import torch
    from apv_tpu_torch import (apply_overrides, evaluate_nll, get_preset,
                               train_loop)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    arrays = {"image": rng.integers(0, 256, size=(4096, 32, 32, 3),
                                    dtype=np.uint8)}
    with tempfile.TemporaryDirectory() as tmp:
        def cfg(name, steps):
            return apply_overrides(get_preset("cifar_advprior_resnet"), [
                f"results_dir={tmp}", f"name={name}", f"train.steps={steps}",
                f"train.log_every={LOG_EVERY}", "train.eval_every=0",
                f"train.checkpoint_every={steps}"])

        out = sys.stdout
        sys.stdout = open(os.devnull, "w")       # the logger's lines
        try:
            train_loop(cfg("warm", WARM_STEPS), arrays=arrays, device=dev)
            timed = cfg("timed", TIMED_STEPS)
            state = train_loop(timed, arrays=arrays, device=dev)
            torch.cuda.synchronize()
        finally:
            sys.stdout.close()
            sys.stdout = out
        recs = [json.loads(x) for x in (Path(tmp) / "timed" / "metrics.jsonl")
                .read_text().splitlines()]
        step_ms = 1e3 * float(np.mean([r["step_time_s"] for r in recs
                                       if "step_time_s" in r]))
        images = arrays["image"][:EVAL_IMAGES]

        def score():
            t0 = time.perf_counter()
            evaluate_nll(timed, state.model, state.d, images, k=EVAL_K,
                         chunk=EVAL_CHUNK, batch_size=EVAL_BATCH, seed=0,
                         device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        score()
        eval_s = score()
    print(json.dumps({"step_ms": step_ms, "eval_s": eval_s}))


def sample(tree: Path, tag: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    p = subprocess.run([sys.executable, "-P", str(ROOT / "loop_ab.py"),
                        "--child"], env=env, capture_output=True, text=True,
                       cwd=tree, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"{tag} sample failed:\n{p.stdout[-3000:]}\n"
                           f"{p.stderr[-3000:]}")
    rec = {"tree": tag, **json.loads(p.stdout.strip().splitlines()[-1])}
    print(json.dumps(rec), flush=True)
    return rec


def summarize(recs: list[dict], pairs: list[tuple[dict, dict]]) -> None:
    import numpy as np
    for metric in ("step_ms", "eval_s"):
        out = {"summary": metric}
        for tag in ("parent", "change"):
            v = np.array([r[metric] for r in recs if r["tree"] == tag])
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            out[tag] = {"median": med, "q1": q1, "q3": q3,
                        "min": v.min(), "max": v.max()}
        out["change_wins"] = sum(c[metric] < p[metric] for p, c in pairs)
        out["pairs"] = len(pairs)
        print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--child", action="store_true")
    a = ap.parse_args(argv)
    if a.child:
        child()
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("loop_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = {"parent": a.parent.resolve(), "change": ROOT}
    # one unrecorded sample each: the kernels' builds
    for tag, tree in trees.items():
        sample(tree, tag)
    recs, pairs = [], []
    for i in range(a.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        got = {tag: sample(trees[tag], tag) for tag in order}
        recs += list(got.values())
        pairs.append((got["parent"], got["change"]))
    summarize(recs, pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
