"""Checkpoint and resume (counterpart of ``apv_tpu/utils/checkpoint.py``).

The port's own format: one ``torch.save`` file per step,
``<dir>/step_<step>.pt``, holding ``TrainState.state_dict()`` (the VAE and
D, both optimizers' moments, counts and, under ``train.grad_accum``, their
running means and micro-steps, the EMA shadow, the step and the seed). A
save
writes a temporary file and renames it, so a reader never sees half a
checkpoint; the last ``max_to_keep`` steps are kept, as the reference's
orbax manager keeps 3. Restoring reads the file onto the CPU and copies
its tensors into a state built by ``init_fn``, bit for bit; a
checkpoint and a state that disagree on the EMA shadow restore as the
reference's do (``TrainState.load_state_dict``).

The reference's orbax checkpoints are not read here.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:09d}.pt"


def _steps(ckpt_dir: str | Path) -> list[int]:
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for p in d.iterdir()
                  if (m := _NAME.match(p.name)))


def save_checkpoint(ckpt_dir: str | Path, state, step: int, *,
                    max_to_keep: int = 3) -> Path:
    """Write ``state`` as step ``step`` and drop all but the newest
    ``max_to_keep`` steps; returns the file written."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = _path(d, step)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    for old in _steps(d)[:-max_to_keep]:
        _path(d, old).unlink()
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest saved step under ``ckpt_dir``, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str | Path, state, step: int | None = None):
    """Copy step ``step`` (default: the newest) into ``state`` in place and
    return it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None or not _path(Path(ckpt_dir), step).exists():
        raise FileNotFoundError(f"no checkpoint of step {step} under "
                                f"{ckpt_dir}")
    saved = torch.load(_path(Path(ckpt_dir), step), map_location="cpu",
                       weights_only=True)
    state.load_state_dict(saved)
    return state
