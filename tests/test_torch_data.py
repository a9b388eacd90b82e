"""The port's data stage against ``apv_tpu``'s, bit for bit: static
binarization (the reference's numpy path and, where it built, its C++
one), bit packing and the device-side unpack, and the Batcher's order."""

import numpy as np
import pytest
import torch

from apv_tpu.data import preprocess as JP
from apv_tpu.data.pipeline import Batcher as JBatcher
from apv_tpu.data.pipeline import stack_batches as j_stack_batches
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
