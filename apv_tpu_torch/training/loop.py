"""The outer training loop on one card (counterpart of
``apv_tpu/training/loop.py``).

The host cuts index (or row) batches with the ``Batcher``; with
``data.device_resident`` the whole train set is uploaded once and each step
gathers its rows on the card, so a step's host-to-device payload is its
int64 indices. ``train.steps_per_call = k`` cuts k batches per loop
iteration, copies them in one transfer and runs the k steps back to back;
metrics are read back from the card only at logged steps, after the
iteration.

Not ported yet, and raising or absent: the dataset loaders (pass
``arrays=``), checkpoint save and ``resume``, periodic validation, the
profiler window and multi-card runs.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.data.pipeline import Batcher, stack_batches
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.logging import MetricLogger


def make_resident_step(base_fn):
    """Wrap a (state, batch) -> (state, metrics) step to take an index
    batch ``{"_index": [B]}`` plus a dataset dict resident on the card: the
    rows are gathered on the device."""
    def _resident_step(state, idx_batch, dataset):
        idx = idx_batch["_index"]
        rows = {k: v.index_select(0, idx) for k, v in dataset.items()}
        return base_fn(state, rows)
    return _resident_step


def train_loop(cfg: Config, *, max_steps: int | None = None,
               arrays: dict[str, np.ndarray] | None = None,
               resume: bool = False, overwrite: bool = False,
               device=None) -> TrainState:
    """Train ``cfg`` from its seed on ``arrays`` and return the final state.

    ``arrays`` holds the train set as the reference's loader would give it
    (``image_packed`` rows for the bit-packed binarized configs, ``image``
    otherwise). ``max_steps`` caps this invocation; the schedules still use
    ``cfg.train.steps``. ``device=None`` means the CUDA card. A results dir
    that holds an earlier run's metrics is refused unless ``overwrite``,
    which clears it first.
    """
    if resume:
        raise NotImplementedError("train_loop: resume needs checkpoints, "
                                  "which the PyTorch port does not save yet")
    if arrays is None:
        raise NotImplementedError("train_loop: the dataset loaders are not "
                                  "ported yet; pass the train set as arrays=")
    fns = make_train_fns(cfg, device=device)
    dev = fns.device
    results_dir = Path(cfg.results_dir) / cfg.name
    if (results_dir / "metrics.jsonl").exists():
        if not overwrite:
            raise FileExistsError(
                f"{results_dir} already holds a run's metrics; pass "
                "overwrite=True to clear it, or choose another cfg.name")
        shutil.rmtree(results_dir)

    k = cfg.train.steps_per_call
    if k > 1:
        for nm, v in (("steps", cfg.train.steps),
                      ("eval_every", cfg.train.eval_every),
                      ("checkpoint_every", cfg.train.checkpoint_every)):
            if v > 0 and v % k:
                raise ValueError(f"train.{nm}={v} must be a multiple of "
                                 f"train.steps_per_call={k}")
    stop = cfg.train.steps if max_steps is None else min(max_steps,
                                                         cfg.train.steps)
    if stop % k:
        raise ValueError(f"cannot run {stop} steps in calls of "
                         f"steps_per_call={k}")

    state = fns.init_fn(cfg.train.seed)
    if cfg.data.device_resident:
        n_rows = len(next(iter(arrays.values())))
        dataset = {kk: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for kk, v in arrays.items()}
        resident = make_resident_step(fns.train_step)

        def step_fn(s, b):
            return resident(s, b, dataset)

        batcher = Batcher({"_index": np.arange(n_rows, dtype=np.int64)},
                          cfg.train.batch_size, seed=cfg.train.seed)
    else:
        step_fn = fns.train_step
        batcher = Batcher(arrays, cfg.train.batch_size, seed=cfg.train.seed)
    calls = stack_batches(batcher, k)

    logger = MetricLogger(results_dir, log_every=cfg.train.log_every,
                          batch_size=cfg.train.batch_size)
    logger.write_json("config.json", dataclasses.asdict(cfg))
    for base in range(0, stop, k):
        stacked = {kk: torch.from_numpy(v).to(dev)
                   for kk, v in next(calls).items()}
        step_metrics = []
        for i in range(k):
            state, m = step_fn(state, {kk: v[i] for kk, v in stacked.items()})
            step_metrics.append(m)
        for i, m in enumerate(step_metrics):
            logger.log(base + i, m)
    return state
