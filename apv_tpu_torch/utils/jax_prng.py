"""``jax.random.normal(jax.random.PRNGKey(seed), (n,), float32)`` in numpy.

The stateless spectral norm (``models/discriminator.py``, ``SNDense``)
starts its power iteration from a fixed vector that the reference draws
with JAX's PRNG; five iterations from any other start give another σ. This
module reproduces that draw without JAX: the key is the seed's (hi, lo)
32-bit words; the counters are the hi and lo words of each flat index
(JAX's partitionable Threefry layout); Threefry-2x32 with 20 rounds maps
each counter pair to two words, which are XORed; the top 23 bits become a
float in [1, 2), minus 1, scaled to [nextafter(−1, 0), 1); then √2·erfinv.
The bits are JAX's exactly; scipy's float64 erfinv, rounded to float32,
differs from XLA's float32 erfinv by a few float32 ulps.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) [uint32]."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, n: int) -> np.ndarray:
    """JAX's ``random_bits(PRNGKey(seed), 32, (n,))`` as uint32 [n], for
    a seed in [0, 2³²) (JAX's key is then (0, seed))."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    key = (0, int(seed))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def normal(seed: int, n: int) -> np.ndarray:
    """JAX's ``random.normal(PRNGKey(seed), (n,), float32)`` as float32 [n]."""
    bits = random_bits(seed, n)
    one = np.array(1.0, np.float32)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(
        np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (one - lo) + lo)
    return (np.sqrt(2.0) * erfinv(u.astype(np.float64))).astype(np.float32)
