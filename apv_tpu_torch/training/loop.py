"""The outer training loop on one card (counterpart of
``apv_tpu/training/loop.py``).

The host cuts index (or row) batches with the ``Batcher``; with
``data.device_resident`` the whole train set is uploaded once and each step
gathers its rows on the card, so a step's host-to-device payload is its
int64 indices. ``train.steps_per_call = k`` cuts k batches per loop
iteration, copies them in one transfer and runs the k steps back to back;
metrics are read back from the card only at logged steps, after the
iteration.

Without ``arrays=`` the train set comes from the dataset loaders
(``data/datasets.py``, their deterministic synthetic fallback where no
files are present), and its tail at ``train.valid_fraction`` is the valid
split. Every ``train.eval_every`` steps the unshuffled valid batches are
scored (``eval_step``), logged, and the best one so far is saved under
``best/`` with ``best.json``; a checkpoint goes to ``checkpoints/`` every
``train.checkpoint_every`` steps and at the invocation's last step.
``resume=True`` restores the newest checkpoint and continues from its step
with the data order of an uninterrupted run (``Batcher.iter_from``),
appending to ``metrics.jsonl``; a resumed run keeps the best valid ELBO of
``best.json``. A fresh run into a results dir that holds checkpoints or
metrics is refused unless ``overwrite``, which clears the dir.

Not ported: the profiler window and multi-card runs.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.data.pipeline import Batcher, stack_batches
from apv_tpu_torch.data.preprocess import pack_bits, static_binarize
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.logging import MetricLogger


def load_train_arrays(cfg: Config) -> tuple[dict[str, np.ndarray],
                                            dict[str, np.ndarray] | None]:
    """(train arrays, valid arrays or None): binarized (and bit-packed)
    for the MNIST configs, uint8 levels otherwise; the valid split is the
    tail of the train set at ``train.valid_fraction``."""
    images, _ = load_dataset(cfg.data.dataset, "train",
                             data_dir=cfg.data.data_dir,
                             synthetic_size=cfg.data.synthetic_size)
    key = "image"
    if cfg.data.binarize:
        images = static_binarize(images, seed=cfg.train.seed)
        if cfg.data.bit_pack:
            images = pack_bits(images)
            key = "image_packed"
    n_valid = int(len(images) * cfg.train.valid_fraction)
    if cfg.train.eval_every <= 0 or n_valid < 1:
        return {key: images}, None
    return {key: images[:-n_valid]}, {key: images[-n_valid:]}


def make_resident_step(base_fn):
    """Wrap a (state, batch) -> (state, metrics) step to take an index
    batch ``{"_index": [B]}`` plus a dataset dict resident on the card: the
    rows are gathered on the device."""
    def _resident_step(state, idx_batch, dataset):
        idx = idx_batch["_index"]
        rows = {k: v.index_select(0, idx) for k, v in dataset.items()}
        return base_fn(state, rows)
    return _resident_step


def _to_device(arrays: dict[str, np.ndarray], dev) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def _valid_batches(cfg: Config, valid_arrays, dev) -> list[dict] | None:
    """The valid split as unshuffled batches on the device (the train
    batch size, or the whole split when it is smaller)."""
    if valid_arrays is None:
        return None
    n = len(next(iter(valid_arrays.values())))
    vb = Batcher(valid_arrays, min(cfg.train.batch_size, n), shuffle=False)
    return [_to_device(b, dev) for b in vb.epoch()]


def train_loop(cfg: Config, *, max_steps: int | None = None,
               arrays: dict[str, np.ndarray] | None = None,
               resume: bool = False, overwrite: bool = False,
               device=None) -> TrainState:
    """Run (or resume) training of ``cfg`` and return the final state.

    ``arrays`` overrides the dataset loaders with a train set as they
    would give it (``image_packed`` rows for the bit-packed binarized
    configs, ``image`` otherwise); it has no valid split. ``max_steps``
    caps this invocation; the schedules still use ``cfg.train.steps``.
    ``device=None`` means the CUDA card.
    """
    fns = make_train_fns(cfg, device=device)
    dev = fns.device
    results_dir = Path(cfg.results_dir) / cfg.name
    ckpt_dir = results_dir / "checkpoints"
    if not resume and (ckpt.latest_step(ckpt_dir) is not None
                       or (results_dir / "metrics.jsonl").exists()):
        if not overwrite:
            raise FileExistsError(
                f"{results_dir} already holds a run (checkpoint step "
                f"{ckpt.latest_step(ckpt_dir)}). Pass resume=True to "
                "continue it, overwrite=True to clear it, or choose "
                "another cfg.name to keep both")
        shutil.rmtree(results_dir)

    state = fns.init_fn(cfg.train.seed)
    start = 0
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        ckpt.restore_checkpoint(ckpt_dir, state)
        start = state.step

    k = cfg.train.steps_per_call
    if k > 1:
        for nm, v in (("steps", cfg.train.steps),
                      ("eval_every", cfg.train.eval_every),
                      ("checkpoint_every", cfg.train.checkpoint_every)):
            if v > 0 and v % k:
                raise ValueError(f"train.{nm}={v} must be a multiple of "
                                 f"train.steps_per_call={k}")
    stop = cfg.train.steps if max_steps is None else min(start + max_steps,
                                                         cfg.train.steps)
    if (stop - start) % k:
        raise ValueError(f"cannot run {stop - start} steps in calls of "
                         f"steps_per_call={k}")
    if stop == start:
        return state                          # nothing left to run

    if arrays is not None:
        train_arrays, valid_arrays = arrays, None
    else:
        train_arrays, valid_arrays = load_train_arrays(cfg)
    if cfg.data.device_resident:
        n_rows = len(next(iter(train_arrays.values())))
        dataset = _to_device(train_arrays, dev)
        resident = make_resident_step(fns.train_step)

        def step_fn(s, b):
            return resident(s, b, dataset)

        batcher = Batcher({"_index": np.arange(n_rows, dtype=np.int64)},
                          cfg.train.batch_size, seed=cfg.train.seed)
    else:
        step_fn = fns.train_step
        batcher = Batcher(train_arrays, cfg.train.batch_size,
                          seed=cfg.train.seed)
    calls = stack_batches(batcher.iter_from(start), k)
    valid_batches = _valid_batches(cfg, valid_arrays, dev)

    logger = MetricLogger(results_dir, log_every=cfg.train.log_every,
                          batch_size=cfg.train.batch_size)
    logger.write_json("config.json", dataclasses.asdict(cfg))
    best_path = results_dir / "best.json"
    best_valid_elbo = (json.loads(best_path.read_text())["valid_elbo"]
                       if resume and best_path.exists() else -float("inf"))

    def run_validation() -> dict[str, float]:
        sums: dict[str, float] = {}
        for b in valid_batches:
            for name, v in fns.eval_step(state, b).items():
                sums[name] = sums.get(name, 0.0) + float(v)
        return {name: v / len(valid_batches) for name, v in sums.items()}

    for base in range(start, stop, k):
        stacked = {kk: torch.from_numpy(v).to(dev)
                   for kk, v in next(calls).items()}
        step_metrics = []
        for i in range(k):
            state, m = step_fn(state, {kk: v[i] for kk, v in stacked.items()})
            step_metrics.append(m)
        for i, m in enumerate(step_metrics):
            logger.log(base + i, m)
        done = base + k                       # steps taken so far
        if valid_batches and cfg.train.eval_every > 0 \
                and done % cfg.train.eval_every == 0:
            vm = run_validation()
            logger.log_now(done, vm)
            if vm["valid_elbo"] > best_valid_elbo:
                best_valid_elbo = vm["valid_elbo"]
                ckpt.save_checkpoint(results_dir / "best", state, done)
                logger.write_json("best.json", {"step": done, **vm})
        if done % cfg.train.checkpoint_every == 0 or done == stop:
            ckpt.save_checkpoint(ckpt_dir, state, done)
    return state
