"""The port's data stage against ``apv_tpu``'s, bit for bit: static
binarization (the reference's numpy path and, where it built, its C++
one), bit packing and the device-side unpack, the Batcher's order (its
resume fast-forward and unshuffled epochs too), the dataset loaders on
synthetic data and on tiny real files of each format, uniform
dequantization and the active-units count."""

import gzip
import io
import pickle
import tarfile

import numpy as np
import pytest
import torch

from apv_tpu.core import metrics as JM
from apv_tpu.data import datasets as JDS
from apv_tpu.data import preprocess as JP
from apv_tpu.data.pipeline import Batcher as JBatcher
from apv_tpu.data.pipeline import stack_batches as j_stack_batches
from apv_tpu_torch.core import metrics as TM
from apv_tpu_torch.data import datasets as TDS
from apv_tpu_torch.data import preprocess as TP
from apv_tpu_torch.data.pipeline import Batcher, stack_batches

torch.set_num_threads(1)


def _images(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 28, 28, 1),
                                                dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_static_binarize_bit_equal(seed):
    imgs = _images(37)
    got = TP.static_binarize(imgs, seed=seed)
    assert got.dtype == np.uint8 and got.shape == imgs.shape
    np.testing.assert_array_equal(got, JP.static_binarize(imgs, seed=seed))
    u = JP._splitmix64_uniform(1000, seed)
    np.testing.assert_array_equal(TP._splitmix64_uniform(1000, seed), u)


@pytest.mark.parametrize("shape", [(5, 28, 28, 1), (3, 5, 3, 1)])
def test_pack_unpack_bit_equal(shape):
    """Little-endian within a byte: bit i of byte j is pixel 8j+i; a pixel
    count that is not a multiple of 8 pads the last byte."""
    bits = (np.random.default_rng(4).random(shape) < 0.5).astype(np.uint8)
    packed = TP.pack_bits(bits)
    np.testing.assert_array_equal(packed, JP.pack_bits(bits))
    got = TP.unpack_bits(torch.from_numpy(packed), shape[1:])
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), bits.astype(np.float32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.unpack_bits(packed, shape[1:])))
    # a k-stacked batch unpacks the same way
    stacked = torch.from_numpy(np.stack([packed, packed]))
    np.testing.assert_array_equal(TP.unpack_bits(stacked, shape[1:])[1],
                                  got)
    one = np.zeros((1, 8), np.uint8)
    one[0, 0] = 1
    assert TP.pack_bits(one.reshape(1, 8, 1, 1))[0, 0] == 1


def test_batcher_order_bit_equal():
    arrays = {"_index": np.arange(103, dtype=np.int64),
              "image_packed": (np.arange(103 * 3) % 256).astype(
                  np.uint8).reshape(103, 3)}
    for seed in (0, 5):
        ours, ref = iter(Batcher(arrays, 16, seed=seed)), iter(
            JBatcher(arrays, 16, seed=seed))
        for _ in range(15):            # 6 batches an epoch: crosses epochs
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    ours = stack_batches(Batcher(arrays, 8, seed=1), 3)
    ref = j_stack_batches(JBatcher(arrays, 8, seed=1), 3)
    for _ in range(5):
        a, b = next(ours)["_index"], next(ref)["_index"]
        assert a.shape == (3, 8)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start", [0, 5, 6, 13, 30])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_iter_from_bit_equal(start, shuffle):
    """The resume fast-forward (6 batches an epoch: within the first
    epoch, at an epoch boundary and epochs later) and unshuffled epochs
    give the reference's batches."""
    arrays = {"_index": np.arange(103, dtype=np.int64)}
    ours = Batcher(arrays, 16, shuffle=shuffle, seed=3).iter_from(start)
    ref = JBatcher(arrays, 16, shuffle=shuffle, seed=3).iter_from(start)
    for _ in range(14):
        np.testing.assert_array_equal(next(ours)["_index"],
                                      next(ref)["_index"])
    if not shuffle:
        first = next(iter(Batcher(arrays, 16, shuffle=False).epoch()))
        np.testing.assert_array_equal(first["_index"], np.arange(16))


def test_batcher_resume_continues_the_stream():
    """iter_from(n) yields what an uninterrupted stream yields after n
    batches."""
    arrays = {"_index": np.arange(50, dtype=np.int64)}
    whole = iter(Batcher(arrays, 8, seed=9))
    for _ in range(11):
        next(whole)
    resumed = Batcher(arrays, 8, seed=9).iter_from(11)
    for _ in range(9):
        np.testing.assert_array_equal(next(whole)["_index"],
                                      next(resumed)["_index"])


def _assert_loaded_equal(got, want):
    (gi, gl), (wi, wl) = got, want
    assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", sorted(JDS.DATASETS))
def test_synthetic_datasets_bit_equal(tmp_path, name, split):
    """The blake2s-seeded synthetic fallback of every dataset and split
    (an empty data dir: no files to find)."""
    got = TDS.load_dataset(name, split, data_dir=tmp_path, synthetic_size=96)
    want = JDS.load_dataset(name, split, data_dir=tmp_path,
                            synthetic_size=96)
    _assert_loaded_equal(got, want)
    assert got[0].shape == (96,) + JDS.DATASETS[name].shape


def test_synthetic_cifar_test_split_full_size_bit_equal(tmp_path):
    """The 10,000-image test split chip_smoke.py scores from."""
    got = TDS.load_dataset("cifar10", "test", data_dir=tmp_path)
    _assert_loaded_equal(got, JDS.load_dataset("cifar10", "test",
                                               data_dir=tmp_path))
    assert got[0].shape == (10_000, 32, 32, 3)


def _idx_bytes(a: np.ndarray) -> bytes:
    magic = (0x08 << 8) | a.ndim
    head = magic.to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in a.shape)
    return head + a.astype(np.uint8).tobytes()


def _cifar_batch(rng, n):
    return pickle.dumps({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))})


def _write_real_files(root, fmt, rng):
    if fmt in ("mnist_idx", "fashion_idx_gz"):
        sub = root / ("mnist" if fmt == "mnist_idx" else "fashion_mnist")
        sub.mkdir(parents=True)
        for prefix, n in (("train", 12), ("t10k", 5)):
            imgs = _idx_bytes(rng.integers(0, 256, (n, 28, 28)))
            labs = _idx_bytes(rng.integers(0, 10, n))
            for stem, data in ((f"{prefix}-images-idx3-ubyte", imgs),
                               (f"{prefix}-labels-idx1-ubyte", labs)):
                if fmt == "fashion_idx_gz":
                    (sub / (stem + ".gz")).write_bytes(gzip.compress(data))
                else:
                    (sub / stem).write_bytes(data)
        return "mnist" if fmt == "mnist_idx" else "fashion_mnist"
    if fmt == "cifar_pickle":
        sub = root / "cifar10" / "cifar-10-batches-py"
        sub.mkdir(parents=True)
        for i in range(1, 6):
            (sub / f"data_batch_{i}").write_bytes(_cifar_batch(rng, 3))
        (sub / "test_batch").write_bytes(_cifar_batch(rng, 4))
        return "cifar10"
    if fmt == "cifar_tarball":
        (root / "cifar10").mkdir(parents=True)
        with tarfile.open(root / "cifar10" / "cifar-10-python.tar.gz",
                          "w:gz") as tf:
            for n in [f"data_batch_{i}" for i in range(1, 6)] + [
                    "test_batch"]:
                data = _cifar_batch(rng, 2)
                info = tarfile.TarInfo(f"cifar-10-batches-py/{n}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        return "cifar10"
    from scipy.io import savemat
    (root / "svhn").mkdir(parents=True)
    for split, n in (("train", 6), ("test", 3)):
        savemat(str(root / "svhn" / f"{split}_32x32.mat"), {
            "X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
            "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})
    return "svhn"


@pytest.mark.parametrize("fmt", ["mnist_idx", "fashion_idx_gz",
                                 "cifar_pickle", "cifar_tarball", "svhn"])
def test_real_file_loaders_bit_equal(tmp_path, fmt):
    """Tiny files of each distribution format, both splits."""
    name = _write_real_files(tmp_path, fmt, np.random.default_rng(4))
    for split in ("train", "test"):
        got = TDS.load_dataset(name, split, data_dir=tmp_path)
        _assert_loaded_equal(got, JDS.load_dataset(name, split,
                                                   data_dir=tmp_path))
        assert got[0].shape[1:] == JDS.DATASETS[name].shape
        assert len(got[0]) < 20                  # the files, not synthetic


@pytest.mark.parametrize("case", ["idx_half", "idx_bare_root",
                                  "cifar_partial", "tarball_missing"])
def test_loaders_fail_loud_on_broken_data_dirs(tmp_path, case):
    """The reference's fail-loud rules: half an idx pair, an idx pair at the
    bare root, some CIFAR batches missing, a tarball missing members."""
    rng = np.random.default_rng(5)
    if case == "idx_half":
        (tmp_path / "mnist").mkdir()
        (tmp_path / "mnist" / "train-images-idx3-ubyte").write_bytes(
            _idx_bytes(rng.integers(0, 256, (2, 28, 28))))
        name = "mnist"
    elif case == "idx_bare_root":
        for stem, shape in (("train-images-idx3-ubyte", (2, 28, 28)),
                            ("train-labels-idx1-ubyte", (2,))):
            (tmp_path / stem).write_bytes(_idx_bytes(rng.integers(
                0, 10, shape)))
        name = "mnist"
    elif case == "cifar_partial":
        (tmp_path / "cifar10").mkdir()
        (tmp_path / "cifar10" / "data_batch_1").write_bytes(
            _cifar_batch(rng, 2))
        name = "cifar10"
    else:
        with tarfile.open(tmp_path / "cifar-10-python.tar.gz", "w:gz") as tf:
            data = _cifar_batch(rng, 2)
            info = tarfile.TarInfo("cifar-10-batches-py/data_batch_1")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        name = "cifar10"
    for load in (TDS.load_dataset, JDS.load_dataset):
        with pytest.raises(FileNotFoundError):
            load(name, "train", data_dir=tmp_path)


def test_uniform_dequantize_range_and_formula():
    """(x + u)/256 in [0, 1), inside the level's own bin [x/256,
    (x+1)/256); the given u is used as is, bit-equal to the reference's
    formula on the same u."""
    levels = torch.arange(256, dtype=torch.uint8).reshape(4, 8, 8, 1)
    y = TP.uniform_dequantize(levels, torch.Generator().manual_seed(1))
    assert y.dtype == torch.float32 and y.shape == levels.shape
    assert float(y.min()) >= 0.0 and float(y.max()) < 1.0
    np.testing.assert_array_equal(torch.floor(y * 256).to(torch.uint8),
                                  levels)
    u = torch.rand(levels.shape, generator=torch.Generator().manual_seed(2))
    got = TP.uniform_dequantize(levels, u=u).numpy()
    want = (levels.numpy().astype(np.float32) + u.numpy()) / np.float32(256)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="u has shape"):
        TP.uniform_dequantize(levels, u=u[:1])


def test_active_units_match_reference():
    rng = np.random.default_rng(6)
    scale = np.where(np.arange(16) < 10, 1.0, 0.01)   # 10 active of 16
    batches = [rng.normal(size=(32, 16)) * scale for _ in range(3)]
    got, var = TM.active_units(iter(batches))
    want, want_var = JM.active_units(iter(batches))
    assert got == want == 10
    np.testing.assert_array_equal(var, want_var)
