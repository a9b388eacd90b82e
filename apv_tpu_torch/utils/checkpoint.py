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

The reference's orbax checkpoints (one numeric directory a step) are read
too: ``latest_step`` and ``restore_checkpoint`` see both formats, the
``.pt`` file winning where both hold a step. An orbax step is read with
``tensorstore`` (imported only then): the tree is rebuilt from the step's
``_METADATA`` key paths, each array read through the ``zarr`` driver over
the ``ocdbt`` kvstore (or the plain ``file`` kvstore of a step written
without OCDBT), and the flax ``TrainState`` tree carried into
``TrainState.state_dict()``'s format by ``convert.train_state_from_flax``.
The EMA branches follow from the checkpoint's own tree, as the
reference's do: a tree without ``ema_params`` (written before the shadow
existed) or with an empty one seeds a wanted shadow from the parameters,
and a saved shadow is dropped by a state without one. ``import_orbax``
writes ``step_<n>.pt`` beside each orbax step, for machines without
tensorstore. Pruning after a save deletes only the port's own files.

Under a process group only rank 0 saves (the training loop calls
``save_checkpoint`` there alone) and every rank restores from the shared
directory; the loop then broadcasts rank 0's state, so a rank that cannot
see the directory still starts from it.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.utils.logging import waits

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:09d}.pt"


def _pt_steps(ckpt_dir: Path) -> list[int]:
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := _NAME.match(p.name)))


def _orbax_steps(ckpt_dir: Path) -> list[int]:
    """orbax's step directories: one numeric name a step (its temporary
    ``<n>.orbax-checkpoint-tmp-*`` directories do not match)."""
    return sorted(int(p.name) for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.isdigit())


def _steps(ckpt_dir: str | Path) -> list[int]:
    """Every step on disk, in either format."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(set(_pt_steps(d)) | set(_orbax_steps(d)))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _write(path: Path, state_dict: dict) -> Path:
    """``torch.save`` to a temporary name, then an atomic rename. The save
    copies each non-empty storage to host memory once, a synchronising
    call from the card."""
    tmp = path.with_name(path.name + ".tmp")
    storages = {t.untyped_storage().data_ptr() for t in _tensors(state_dict)
                if t.untyped_storage().nbytes()}
    with waits("save", len(storages)):
        torch.save(state_dict, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str | Path, state, step: int, *,
                    max_to_keep: int = 3) -> Path:
    """Write ``state`` as step ``step`` and drop all but the newest
    ``max_to_keep`` of the port's own files (an orbax step is never
    deleted); returns the file written."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = _write(_path(d, step), state.state_dict())
    for old in _pt_steps(d)[:-max_to_keep]:
        _path(d, old).unlink()
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest saved step under ``ckpt_dir``, in either format, or
    None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str | Path, state, step: int | None = None):
    """Copy step ``step`` (default: the newest) into ``state`` in place and
    return it: the port's ``.pt`` file of that step, else the reference's
    orbax step."""
    d = Path(ckpt_dir)
    step = latest_step(d) if step is None else step
    if step is not None and _path(d, step).exists():
        saved = torch.load(_path(d, step), map_location="cpu",
                           weights_only=True)
    elif step is not None and (d / str(step)).is_dir():
        from apv_tpu_torch.convert import train_state_from_flax
        saved = train_state_from_flax(read_orbax_tree(d / str(step)), state)
    else:
        raise FileNotFoundError(f"no checkpoint of step {step} under "
                                f"{ckpt_dir}")
    with waits("restore", _copies(state, saved)):
        state.load_state_dict(saved)
    return state


def _copies(state, saved: dict) -> int:
    """The copies from host memory ``state.load_state_dict(saved)`` makes:
    one a non-empty tensor of the state, but an accumulator the saved
    state lacks."""
    n = sum(1 for t in state.tensors() if t.numel())
    for opt, key in ((state.opt, "opt"), (state.d_opt, "d_opt")):
        if opt is not None and opt.acc is not None and "acc" not in saved[
                key]:
            n -= sum(1 for t in opt.acc if t.numel())
    return n


def import_orbax(ckpt_dir: str | Path, step: int | None = None
                 ) -> list[Path]:
    """Write ``step_<n>.pt`` beside the orbax step ``step`` (default: each
    orbax step under ``ckpt_dir``), so that a machine without tensorstore
    restores the reference's run. The state's structure comes from the
    run's ``config.json`` beside ``ckpt_dir``. Returns the files
    written."""
    from apv_tpu_torch.api import _decode_result_json
    from apv_tpu_torch.convert import train_state_from_flax
    from apv_tpu_torch.training.step import make_train_fns
    from apv_tpu_torch.utils.config import config_from_dict

    d = Path(ckpt_dir)
    steps = _orbax_steps(d) if step is None else [step]
    if not steps:
        raise FileNotFoundError(f"no orbax step under {ckpt_dir}")
    cfg = config_from_dict(_decode_result_json(
        (d.parent / "config.json").read_text()))
    state = make_train_fns(cfg, device="cpu").init_fn(cfg.train.seed)
    written = []
    for s in steps:
        written.append(_write(_path(d, s), train_state_from_flax(
            read_orbax_tree(d / str(s)), state)))
    return written


# ---------------------------------------------------------------------------
# the orbax reader
# ---------------------------------------------------------------------------

_SEQUENCE_KEY = 1       # _METADATA's key_type of a list or tuple index
_EMPTY = {"None": None, "Tuple": (), "List": [], "Dict": {}}


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a reference (orbax) checkpoint needs the tensorstore "
            "package, which is not installed here. Where it is, "
            "apv_tpu_torch.utils.checkpoint.import_orbax(ckpt_dir) writes "
            "step_<n>.pt files beside the orbax steps, which this machine "
            "reads") from e
    return tensorstore


def _item_dir(step_dir: Path) -> Path:
    """The directory holding ``_METADATA``: the manager's single item
    (``default``), or the step itself."""
    item = step_dir / "default"
    return item if (item / "_METADATA").exists() else step_dir


def _listify(node):
    """Nodes keyed by sequence index -> lists, recursively."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return [_listify(node[i]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def read_orbax_tree(step_dir: str | Path) -> dict:
    """An orbax ``StandardSave`` step -> its tree: dicts (NamedTuple
    fields by name), lists (tuple indices) and numpy leaves; empty nodes
    as None, (), [] or {}. Needs tensorstore."""
    ts = _tensorstore()
    item = _item_dir(Path(step_dir)).absolute()
    meta = json.loads((item / "_METADATA").read_text())
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    ocdbt = (item / "manifest.ocdbt").exists()
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        path = [int(k["key"]) if k["key_type"] == _SEQUENCE_KEY else k["key"]
                for k in keys]
        if value.get("skip_deserialize"):
            leaf = _EMPTY.get(value.get("value_type"))
        else:
            name = ".".join(str(k["key"]) for k in keys)
            kvstore = ({"driver": "ocdbt", "base": f"file://{item}/",
                        "path": name} if ocdbt
                       else {"driver": "file", "path": f"{item / name}/"})
            leaf = np.asarray(ts.open({"driver": driver,
                                       "kvstore": kvstore}).result()
                              .read().result())
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _listify(tree)
