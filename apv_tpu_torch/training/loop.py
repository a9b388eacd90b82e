"""The outer training loop, on one card or one card a rank of a process
group (counterpart of ``apv_tpu/training/loop.py``).

The host cuts index (or row) batches with the ``Batcher``; with
``data.device_resident`` the whole train set is uploaded once and each step
gathers its rows on the card, so a step's host-to-device payload is its
int64 indices. ``train.steps_per_call = k`` cuts k batches per loop
iteration, copies them in one transfer and runs the k steps back to back;
metrics are read back from the card only at logged steps, after the
iteration. On a CUDA device without a process group and without gradient
accumulation, the invocation's first step runs eagerly and every later
one replays a CUDA graph captured of the second (``training/graph.py``):
the host then launches one graph a step, not its several hundred kernels.

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

``trace_dir`` traces steps 10-15 of this invocation with torch.profiler
(``utils/logging.py``). Ctrl-C saves a checkpoint and re-raises, so
``resume=True`` continues there. The port's state updates in place, so
while the loop runs in the main thread SIGINT only raises a flag, read
once after each call of k steps (after its logging, validation and
periodic save): the checkpoint is at the end of that call, a step count
that the k-step calls, ``eval_every`` and ``checkpoint_every`` of a
resumed run line up with, as the reference's is. A second Ctrl-C stops at
once and saves nothing, as does a KeyboardInterrupt that comes from
inside a call's steps: either may leave a step half-applied.

Under a process group (``parallel/multihost.py``, one process a card) every
rank runs this loop: after init or restore the state is broadcast from
rank 0; each rank cuts its rows of every global batch (``Batcher(
host_shard=...)``; with ``data.device_resident`` every rank uploads the
whole train set and cuts its index rows) and the step averages the
gradients. Only rank 0 writes: checkpoints, ``best/``, ``best.json``,
``config.json``, ``metrics.jsonl`` and the clearing of ``overwrite``. The
stale-run refusal is agreed (``agree_max``) so that every rank raises or
none does; the valid batches are rounded to split over the ranks and their
means averaged; the logged metrics are group means, reduced once a call in
one stacked tensor; Ctrl-C is agreed after each call (one ``all_reduce``
when there is more than one rank), so the ranks stop at the same call
boundary. The loop ends with a barrier: rank 0's last checkpoint exists
before any rank returns. A second Ctrl-C, which stops at once, leaves the
other ranks to their collectives' time-outs.

The span recorder of ``utils/logging.py`` is always on and keeps
aggregates only: each call of ``train_loop`` is one ``train_loop``
invocation, with spans ``loop.data`` (the next call's batches cut and
copied), ``loop.step`` (one ``train_step``; inside it ``step.d_phase``,
``step.g_phase``, the optimizers ``step.d_opt`` and ``step.g_opt``, and
``step.ema``), ``loop.readback`` (a logged record's read-back),
``loop.validate`` and ``loop.save``; on the card, device markers at each
step's start and end and at each phase's start (a replayed step has only
its own two: its phases run inside the graph); and the synchronising
calls counted where they are made (the models' upload, the resident train
set's and each valid batch's, each metric read back, a checkpoint's
restore and save). Each logged record after the first adds, per step of
its interval, ``host_step_ms``, ``sync_wait_ms``, ``host_lead_ms`` (on
the card) and the phases' and optimizers' self ms; its interval in the
invocation's summary also counts the ``captures`` and ``replayed_steps``
of the captured step. Only while a profiler
runs (``trace_dir``) is each span also a ``record_function`` range: the
trace names the loop's spans.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import signal
import threading
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.data.pipeline import (Batcher, prefetch_to_device,
                                         stack_batches)
from apv_tpu_torch.data.preprocess import pack_bits, static_binarize
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.training.graph import StepRunner, capturable
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device
from apv_tpu_torch.utils.logging import (MetricLogger, invocation, read, span,
                                         waits)


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


class _CallBoundaryInterrupt:
    """While active in the main thread, the first SIGINT only sets
    ``requested``; a second sets ``forced`` and raises at once. Elsewhere
    it does nothing."""

    def __init__(self):
        self.requested = self.forced = False
        self._old = None

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._old = signal.signal(signal.SIGINT, self._handle)
        return self

    def _handle(self, signum, frame):
        if self.requested:
            self.forced = True
            raise KeyboardInterrupt
        self.requested = True

    def __exit__(self, *exc):
        if self._old is not None:
            signal.signal(signal.SIGINT, self._old)
        return False


def _valid_batches(cfg: Config, valid_arrays, dev) -> list[dict] | None:
    """The valid split as unshuffled batches on the device (the train
    batch size, or the whole split when it is smaller, rounded to split
    over the ranks), this rank's rows of each."""
    if valid_arrays is None:
        return None
    n = len(next(iter(valid_arrays.values())))
    vbs = multihost.round_global_batch(min(cfg.train.batch_size, n))
    if vbs > n:
        print(f"warning: validation disabled: the valid split ({n} rows) "
              f"is smaller than a batch that splits over "
              f"{multihost.process_count()} ranks", flush=True)
        return None
    vb = Batcher(valid_arrays, vbs, shuffle=False,
                 host_shard=multihost.host_shard())
    return [_upload(b, dev) for b in vb.epoch()]


def _upload(arrays: dict[str, np.ndarray], dev) -> dict[str, torch.Tensor]:
    """``multihost.put_batch``: one copy from pageable host memory a
    non-empty array, each a synchronising call on the card."""
    with waits("upload", sum(1 for v in arrays.values() if v.size)):
        return multihost.put_batch(arrays, dev)


def broadcast_state(state: TrainState, src: int = 0) -> None:
    """Copy rank ``src``'s state into every rank's, in place: the step,
    the seed, the parameters and buffers of the VAE, D and the EMA shadow,
    and both optimizers' counts, micro-steps, moments and accumulators."""
    opts = [o for o in (state.opt, state.d_opt) if o is not None]
    ints = [state.step, state.seed]
    for o in opts:
        ints += [o.count, o.mini_step]
    multihost.broadcast_(state.tensors(), src)
    ints = multihost.broadcast_ints(ints, src)
    state.step, state.seed = ints[:2]
    for i, o in enumerate(opts):
        o.count, o.mini_step = ints[2 + 2 * i:4 + 2 * i]


def _group_means(records: list[dict], dev) -> list[dict]:
    """The tensor metrics of ``records`` averaged over the group in one
    stacked all-reduce (Python numbers are the same on every rank)."""
    keys = [(i, k) for i, r in enumerate(records) for k, v in r.items()
            if torch.is_tensor(v)]
    if not keys:
        return records
    flat = [records[i][k].detach().to(dev, torch.float32).reshape(-1)
            for i, k in keys]
    stacked = torch.cat(flat)
    multihost.average_([stacked])
    out = [dict(r) for r in records]
    for (i, k), v in zip(keys, stacked.split([t.numel() for t in flat])):
        out[i][k] = v.reshape(records[i][k].shape)
    return out


def train_loop(cfg: Config, *, max_steps: int | None = None,
               arrays: dict[str, np.ndarray] | None = None,
               resume: bool = False, overwrite: bool = False,
               trace_dir: str | None = None, device=None) -> TrainState:
    """Run (or resume) training of ``cfg`` and return the final state.

    ``arrays`` overrides the dataset loaders with a train set as they
    would give it (``image_packed`` rows for the bit-packed binarized
    configs, ``image`` otherwise); it has no valid split. ``max_steps``
    caps this invocation; the schedules still use ``cfg.train.steps``.
    ``trace_dir`` writes the profiler window's trace there. ``device=None``
    means the CUDA card. The call is one ``train_loop`` invocation of the
    span recorder (``utils/logging.py``).
    """
    with invocation("train_loop", resolve_device(device)):
        return _train_loop(cfg, max_steps, arrays, resume, overwrite,
                           trace_dir, device)


def _train_loop(cfg: Config, max_steps, arrays, resume, overwrite, trace_dir,
                device) -> TrainState:
    fns = make_train_fns(cfg, device=device)
    dev = fns.device
    results_dir = Path(cfg.results_dir) / cfg.name
    ckpt_dir = results_dir / "checkpoints"
    primary = multihost.process_index() == 0
    sync = multihost.active()
    # what this rank sees: a checkpoint's step, 0 for a metrics file alone
    seen = ckpt.latest_step(ckpt_dir)
    if seen is None and (results_dir / "metrics.jsonl").exists():
        seen = 0
    if not resume and multihost.agree_max(seen) is not None:
        if not overwrite:
            raise FileExistsError(
                f"{results_dir} already holds a run (checkpoint step "
                f"{ckpt.latest_step(ckpt_dir)}). Pass resume=True to "
                "continue it, overwrite=True to clear it, or choose "
                "another cfg.name to keep both")
        if primary:
            shutil.rmtree(results_dir, ignore_errors=True)

    state = fns.init_fn(cfg.train.seed)
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        ckpt.restore_checkpoint(ckpt_dir, state)
    if sync:
        broadcast_state(state)
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
        dataset = _upload(train_arrays, dev)

        def rows_of(b):
            """An index batch ``{"_index": [B]}``'s rows, gathered on the
            card from the resident train set."""
            return {kk: v.index_select(0, b["_index"])
                    for kk, v in dataset.items()}

        batcher = Batcher({"_index": np.arange(n_rows, dtype=np.int64)},
                          cfg.train.batch_size, seed=cfg.train.seed,
                          host_shard=multihost.host_shard())
    else:
        def rows_of(b):
            return b

        batcher = Batcher(train_arrays, cfg.train.batch_size,
                          seed=cfg.train.seed,
                          host_shard=multihost.host_shard())
    step_fn = StepRunner(fns, capturable(cfg, dev))
    calls = prefetch_to_device(stack_batches(batcher.iter_from(start), k),
                               dev)
    valid_batches = _valid_batches(cfg, valid_arrays, dev)

    logger = MetricLogger(results_dir, log_every=cfg.train.log_every,
                          batch_size=cfg.train.batch_size,
                          trace_dir=trace_dir, trace_offset=start,
                          trace_cuda=dev.type == "cuda")
    logger.write_json("config.json", dataclasses.asdict(cfg))
    best_path = results_dir / "best.json"
    best_valid_elbo = (json.loads(best_path.read_text())["valid_elbo"]
                       if resume and best_path.exists() else -float("inf"))

    def run_validation() -> dict[str, float]:
        sums: dict[str, float] = {}
        for b in valid_batches:
            for name, v in fns.eval_step(state, b).items():
                sums[name] = sums.get(name, 0.0) + read(v)
        means = {name: v / len(valid_batches) for name, v in sums.items()}
        if sync:
            names = sorted(means)
            with waits("upload"):
                t = torch.tensor([means[n] for n in names],
                                 dtype=torch.float64, device=dev)
            t = multihost.all_reduce(t) / multihost.process_count()
            with waits("read"):
                means = dict(zip(names, t.tolist()))
        return means

    interrupt = _CallBoundaryInterrupt()
    in_call = False                       # inside a call's k steps
    saved = None                          # the step last checkpointed
    try:
        with interrupt:
            for base in range(start, stop, k):
                logger.maybe_trace(base, stride=k)
                with span("loop.data"):
                    stacked = next(calls)
                step_metrics = []
                in_call = True
                for i in range(k):
                    with span("loop.step", unit=base + i, marks="both"):
                        state, m = step_fn(state, rows_of({
                            kk: v[i] for kk, v in stacked.items()}))
                    step_metrics.append(m)
                in_call = False
                logged = [(base + i, m) for i, m in enumerate(step_metrics)
                          if (base + i) % logger.log_every == 0]
                if sync and logged:
                    logged = list(zip([s for s, _ in logged], _group_means(
                        [m for _, m in logged], dev)))
                for step, m in logged:
                    logger.log(step, m)
                done = base + k                   # steps taken so far
                if valid_batches and cfg.train.eval_every > 0 \
                        and done % cfg.train.eval_every == 0:
                    with span("loop.validate"):
                        vm = run_validation()
                        logger.log_now(done, vm)
                    if vm["valid_elbo"] > best_valid_elbo:
                        best_valid_elbo = vm["valid_elbo"]
                        if primary:
                            with span("loop.save"):
                                ckpt.save_checkpoint(results_dir / "best",
                                                     state, done)
                        logger.write_json("best.json", {"step": done, **vm})
                if done % cfg.train.checkpoint_every == 0 or done == stop:
                    if primary:
                        with span("loop.save"):
                            ckpt.save_checkpoint(ckpt_dir, state, done)
                    saved = done
                stop_now = interrupt.requested
                if multihost.process_count() > 1:
                    stop_now = bool(multihost.agree_max(int(stop_now)))
                if stop_now:
                    raise KeyboardInterrupt
    except KeyboardInterrupt:
        if interrupt.forced or in_call:
            print("interrupted with a step possibly half-applied; nothing "
                  "saved, --resume continues from step "
                  f"{ckpt.latest_step(ckpt_dir) or 0}", flush=True)
        else:
            if saved != state.step and primary:
                with span("loop.save"):
                    ckpt.save_checkpoint(ckpt_dir, state, state.step)
            print(f"interrupted at step {state.step}; checkpoint saved, "
                  "resume with --resume", flush=True)
        raise
    finally:
        step_fn.close()
        logger.close()
    multihost.barrier()
    return state
