"""Input preprocessing (counterpart of ``apv_tpu/data/preprocess.py``):
static binarization and bit packing on the host in numpy, bit unpacking and
uniform dequantization on the device in torch, and the eval-time level
mapping.

The splitmix64 stream is the reference's numpy path, which is bit-identical
to its C++ one (``apv_binarize_u8``), so a seed binarizes a dataset the same
way in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def _splitmix64_uniform(n: int, seed: int) -> np.ndarray:
    """Vectorized splitmix64 -> f32 uniforms in [0, 1) from the 24 high
    bits of each output."""
    golden = np.uint64(0x9E3779B97F4A7C15)
    state0 = np.uint64(seed) ^ np.uint64(0xD1B54A32D192ED03)
    with np.errstate(over="ignore"):
        s = state0 + (np.arange(1, n + 1, dtype=np.uint64)) * golden
        z = (s ^ (s >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    r = (z >> np.uint64(40)).astype(np.float32)       # 24 high bits
    return r * np.float32(1.0 / 16777216.0)


def static_binarize(images_u8: np.ndarray, seed: int = 0) -> np.ndarray:
    """Static Bernoulli binarization, b ~ Bernoulli(pixel/255) drawn once
    for the whole run: uint8 in {0, 1}, of the input's shape."""
    u = _splitmix64_uniform(images_u8.size, seed).reshape(images_u8.shape)
    return (u * np.float32(255.0)
            < images_u8.astype(np.float32)).astype(np.uint8)


def pack_bits(images01: np.ndarray) -> np.ndarray:
    """{0,1} images [N, H, W, C] -> bit-packed [N, ceil(H·W·C/8)] uint8,
    8 pixels per byte, little-endian within a byte (bit i of byte j is
    pixel 8j+i): the exact inverse of ``unpack_bits``."""
    n = images01.shape[0]
    flat = np.ascontiguousarray(images01.reshape(n, -1)).astype(np.uint8)
    return np.packbits(flat, axis=1, bitorder="little")


def unpack_bits(packed: torch.Tensor,
                image_shape: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of ``pack_bits`` on ``packed``'s device: [..., nbytes] uint8
    -> [..., H, W, C] float32 in {0, 1}, bit i of each byte first."""
    h, w, c = image_shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return (flat[..., :h * w * c]
            .reshape(packed.shape[:-1] + (h, w, c))
            .to(torch.float32))


def to_unit_interval(images_u8: np.ndarray) -> np.ndarray:
    """uint8 levels -> bin centers i/255 in [0,1] (discretized-logistic grid)."""
    return images_u8.astype(np.float32) / 255.0


def uniform_dequantize(images_u8: torch.Tensor,
                       generator: torch.Generator | None = None, *,
                       u: torch.Tensor | None = None) -> torch.Tensor:
    """(x + u)/256 with u ~ U[0, 1) drawn on the images' device from
    ``generator`` (a generator of that device), or the given ``u`` of the
    images' shape: float32 in [0, 1)."""
    if u is None:
        u = torch.rand(images_u8.shape, generator=generator,
                       device=images_u8.device)
    elif u.shape != images_u8.shape:
        raise ValueError(f"uniform_dequantize: u has shape {tuple(u.shape)}, "
                         f"images {tuple(images_u8.shape)}")
    return (images_u8.to(torch.float32) + u) / 256.0


def normalize_center(x):
    """[0,1] -> [-1,1]; works on numpy arrays and torch tensors alike."""
    return x * 2.0 - 1.0
