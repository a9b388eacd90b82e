"""Dataset loaders: real files when present, deterministic synthetic fallback
(the port's own copy of ``apv_tpu/data/datasets.py``, numpy only; scipy
only to read SVHN files).

All loaders return ``(images, labels)`` with ``images`` uint8
``[N, H, W, C]`` and ``labels`` int32 ``[N]``, bit-identical to the
reference's for the same files, and for the synthetic fallback of every
dataset and split (``tests/test_torch_data.py`` holds the two copies equal).

Real-file formats understood (standard public distribution formats):
  * MNIST / FashionMNIST: idx ubyte files, optionally gzipped
    (``train-images-idx3-ubyte[.gz]`` etc.) under ``<dir>/mnist`` or
    ``<dir>/fashion_mnist``.
  * CIFAR-10: the python pickle batches (``data_batch_1..5``, ``test_batch``)
    under ``<dir>/cifar10[/cifar-10-batches-py]``, or the distribution
    tarball ``cifar-10-python.tar.gz``.
  * SVHN: ``train_32x32.mat`` / ``test_32x32.mat`` under ``<dir>/svhn``.

The data dir is ``data_dir``, else ``$APV_DATA_DIR``, else ``data/`` at the
root of the checkout.
"""

from __future__ import annotations

import gzip
import os
import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    shape: tuple[int, int, int]       # H, W, C
    n_train: int
    n_test: int
    n_classes: int = 10


DATASETS: dict[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", (28, 28, 1), 60_000, 10_000),
    "fashion_mnist": DatasetSpec("fashion_mnist", (28, 28, 1), 60_000, 10_000),
    "cifar10": DatasetSpec("cifar10", (32, 32, 3), 50_000, 10_000),
    "svhn": DatasetSpec("svhn", (32, 32, 3), 73_257, 26_032),
}


def default_data_dir() -> Path:
    checkout = Path(__file__).resolve().parents[2]
    return Path(os.environ.get("APV_DATA_DIR", checkout / "data"))


# ---------------------------------------------------------------------------
# Real-file readers
# ---------------------------------------------------------------------------

def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find(dirs: list[Path], names: list[str]) -> Path | None:
    for d in dirs:
        for n in names:
            for cand in (d / n, d / (n + ".gz")):
                if cand.exists():
                    return cand
    return None


def _load_idx_pair(root: Path, subdir: str, split: str):
    prefix = "train" if split == "train" else "t10k"
    # idx files MUST live under the named subdir (<root>/mnist,
    # <root>/fashion_mnist): MNIST and FashionMNIST ship with IDENTICAL
    # filenames, so a bare-root fallback would silently resolve both
    # datasets to the same files and score the OOD pair in-dist vs
    # in-dist (AUROC ~0.5 with no error).
    dirs = [root / subdir]
    img = _find(dirs, [f"{prefix}-images-idx3-ubyte"])
    lab = _find(dirs, [f"{prefix}-labels-idx1-ubyte"])
    if img is None and lab is None:
        # A COMPLETE idx pair at the bare root is a misplaced layout, not
        # absence: raising with the expected subdir beats silently
        # training on synthetic data the user believes is real (the same
        # fail-loud rule as the half-present case below).
        if (_find([root], [f"{prefix}-images-idx3-ubyte"]) is not None
                and _find([root], [f"{prefix}-labels-idx1-ubyte"])
                is not None):
            raise FileNotFoundError(
                f"found {prefix}-* idx files at the bare data root {root}: "
                "MNIST and FashionMNIST ship identical filenames, so the "
                f"root is ambiguous — move them under {root / subdir}")
        return None
    if img is None or lab is None:
        # Half a real dataset is a broken mount, not an invitation to
        # silently train on synthetic data.
        raise FileNotFoundError(
            f"{subdir}/{split}: found {'images' if img else 'labels'} but "
            f"not {'labels' if img else 'images'} under {root / subdir} — "
            "fix the data dir rather than falling back to synthetic")
    images = _read_idx(img)[..., None]            # [N, 28, 28, 1]
    labels = _read_idx(lab).astype(np.int32)
    return images, labels


def _load_cifar10_targz(root: Path, split: str):
    """Read CIFAR-10 straight from the distribution tarball
    (``cifar-10-python.tar.gz`` — the file the download page actually
    serves) without requiring extraction: members stream through
    ``tarfile``, so a mounted archive is enough to train on."""
    import tarfile

    names = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])
    for base in (root, root / "cifar10"):
        path = base / "cifar-10-python.tar.gz"
        if not path.exists():
            continue
        imgs, labs = [], []
        with tarfile.open(path, "r:gz") as tf:
            members = {m.name.rsplit("/", 1)[-1]: m for m in tf.getmembers()}
            missing = [n for n in names if n not in members]
            if missing:
                raise FileNotFoundError(
                    f"cifar10/{split}: {path} is missing members {missing} "
                    "— a corrupt or non-standard archive, not an "
                    "invitation to silently train on synthetic data")
            for n in names:
                d = pickle.load(tf.extractfile(members[n]),
                                encoding="bytes")
                imgs.append(np.asarray(d[b"data"], np.uint8))
                labs.extend(d[b"labels"])
        images = (np.concatenate(imgs).reshape(-1, 3, 32, 32)
                  .transpose(0, 2, 3, 1))
        return np.ascontiguousarray(images), np.asarray(labs, np.int32)
    return None


def _load_cifar10(root: Path, split: str):
    for base in (root / "cifar10" / "cifar-10-batches-py",
                 root / "cifar-10-batches-py", root / "cifar10"):
        names = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        present = [n for n in names if (base / n).exists()]
        if present and len(present) < len(names):
            raise FileNotFoundError(
                f"cifar10/{split}: {base} holds {present} but is missing "
                f"{sorted(set(names) - set(present))} — fix the data dir "
                "rather than falling back to synthetic")
        if len(present) < len(names):
            continue
        imgs, labs = [], []
        for n in names:
            with open(base / n, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(np.asarray(d[b"data"], np.uint8))
            labs.extend(d[b"labels"])
        images = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(images), np.asarray(labs, np.int32)
    # extracted batches absent: accept the unextracted distribution tarball
    return _load_cifar10_targz(root, split)


def _load_svhn(root: Path, split: str):
    name = "train_32x32.mat" if split == "train" else "test_32x32.mat"
    for base in (root / "svhn", root):
        if (base / name).exists():
            from scipy.io import loadmat
            d = loadmat(str(base / name))
            images = np.ascontiguousarray(d["X"].transpose(3, 0, 1, 2))
            labels = d["y"].reshape(-1).astype(np.int32) % 10   # '10' means 0
            return images.astype(np.uint8), labels
    return None


# ---------------------------------------------------------------------------
# Deterministic synthetic fallback (SURVEY.md §7 risk R1)
# ---------------------------------------------------------------------------

# Per-dataset frequency-family offsets: guarantees distinct synthetic
# distributions for the OOD pairs (mnist vs fashion_mnist, cifar10 vs svhn).
_FAMILY_OFFSET = {"mnist": 0.0, "fashion_mnist": 2.5,
                  "cifar10": 0.7, "svhn": 3.1}


def _stable_seed(*parts: str) -> int:
    """Process-independent seed (python's hash() is salted per process)."""
    import hashlib
    digest = hashlib.blake2s("/".join(parts).encode(),
                             digest_size=4).digest()
    return int.from_bytes(digest, "big")


def _synthetic(spec: DatasetSpec, split: str, n: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Structured procedural images: class-conditional low-frequency fields.

    Not noise — each class mixes two spatial sinusoids with class-dependent
    frequency/phase plus a per-sample Gaussian blob, so a VAE has real
    structure to model and OOD pairs (different name → different statistics)
    remain distinguishable. Deterministic in (dataset, split) across
    processes; the frequency *family* depends on the dataset name only, so
    train and test splits are draws from the same distribution.
    """
    h, w, c = spec.shape
    n = n if n is not None else (spec.n_train if split == "train" else spec.n_test)
    rng = np.random.default_rng(_stable_seed(spec.name, split))

    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w

    # class-dependent frequencies; dataset name shifts the whole family so
    # e.g. synthetic mnist vs fashion_mnist differ in distribution.
    base = 2.0 + _FAMILY_OFFSET.get(spec.name, _stable_seed(spec.name) % 5)
    freq = base + labels[:, None, None].astype(np.float32)          # [n,1,1]
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1)).astype(np.float32)
    field = (np.sin(2 * np.pi * freq * xx[None] + phase)
             * np.cos(2 * np.pi * (freq * 0.5) * yy[None] + 0.7 * phase))

    cy = rng.uniform(0.2, 0.8, size=(n, 1, 1)).astype(np.float32)
    cx = rng.uniform(0.2, 0.8, size=(n, 1, 1)).astype(np.float32)
    blob = np.exp(-(((yy[None] - cy) ** 2 + (xx[None] - cx) ** 2) / 0.02))

    img = 0.5 + 0.25 * field + 0.5 * blob                            # [n,h,w]
    if c == 1:
        img = img[..., None]
    else:
        chan = rng.uniform(0.6, 1.0, size=(n, 1, 1, c)).astype(np.float32)
        img = img[..., None] * chan
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), labels


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def load_dataset(name: str, split: str = "train", *,
                 data_dir: str | os.PathLike | None = None,
                 synthetic_size: int | None = None,
                 allow_synthetic: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Load ``(images uint8 [N,H,W,C], labels int32 [N])``.

    Tries real files under ``data_dir`` first; falls back to the
    deterministic synthetic dataset (unless ``allow_synthetic=False``).
    ``synthetic_size`` overrides the fallback's N (tests use small values).
    """
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    spec = DATASETS[name]
    root = Path(data_dir) if data_dir is not None else default_data_dir()

    loaded = None
    if name in ("mnist", "fashion_mnist"):
        loaded = _load_idx_pair(root, name, split)
    elif name == "cifar10":
        loaded = _load_cifar10(root, split)
    elif name == "svhn":
        loaded = _load_svhn(root, split)

    if loaded is not None:
        images, labels = loaded
        expected = (None,) + spec.shape
        if images.shape[1:] != spec.shape:
            raise ValueError(
                f"{name}/{split}: file shape {images.shape[1:]} != {expected[1:]}")
        return images, labels

    if not allow_synthetic:
        raise FileNotFoundError(
            f"no {name} files under {root} and synthetic fallback disabled")
    if data_dir is not None or "APV_DATA_DIR" in os.environ:
        # The caller explicitly pointed at real data; a silent synthetic
        # run would report results the user believes are real.
        print(f"warning: no {name} files under {root}; using the "
              "deterministic synthetic fallback", flush=True)
    return _synthetic(spec, split, synthetic_size)
