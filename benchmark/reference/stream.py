"""The noise streams of the program, worked out again in plain torch.

The program draws its noise from keys that it takes from seeded
``torch.Generator``s, in a fixed order, so the reference can draw the same
noise from the same seeds:

* the reparameterization noise: a key (seed, offset) from one
  ``torch.randint(0, 2**63 - 1, (2,))`` on a CPU generator, expanded by
  Philox4x32-10 (Salmon et al., SC'11) on counters (q_lo, q_hi, offset_lo,
  offset_hi) under the key (seed_lo, seed_hi), four words a counter, each
  pair (u1, u2) of 23-bit uniforms (m + 0.5)·2^-23 turned into two normals
  by Box-Muller, r = sqrt(-2 ln u1), θ = 2π·u2, (r cos θ, r sin θ);
* a train step's generator: a CPU generator seeded by the two 32-bit words
  of ``numpy.random.SeedSequence([seed, step])``;
* the device draws (uniform dequantization, the critic's prior samples): a
  device generator seeded from one ``torch.randint(0, 2**63 - 1, (1,))``
  on the step's generator, then ``torch.rand`` or ``torch.randn``.

A frozen copy: if the program changes its streams, this file stays, and
the comparison says so.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = 6.2831855


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of a·b, a a 32-bit int, b int64 holding 32 bits."""
    t_hi = (a >> 16) * b
    t_lo = (a & 0xFFFF) * b
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors holding 32-bit words."""
    for r in range(10):
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        ka, kb = (k0 + r * _W[0]) & _MASK, (k1 + r * _W[1]) & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ ka, lo1, hi0 ^ c3 ^ kb, lo0
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def normals(total: int, seed: int, offset: int,
            device: torch.device | str) -> torch.Tensor:
    """``total`` N(0, 1) draws of the key (seed, offset), in order."""
    q = torch.arange((total + 3) // 4, dtype=torch.int64, device=device)
    full = torch.full_like
    c = philox(q & _MASK, q >> 32, full(q, offset & _MASK),
               full(q, (offset >> 32) & _MASK), seed & _MASK,
               (seed >> 32) & _MASK)
    out = []
    for w1, w2 in ((c[0], c[1]), (c[2], c[3])):
        r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(_uniform(w1),
                                                        1e-12)))
        theta = _TWO_PI_F32 * _uniform(w2)
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(out, dim=-1).reshape(-1)[:total]


def draw_key(gen: torch.Generator) -> tuple[int, int]:
    seed, offset = torch.randint(0, 2 ** 63 - 1, (2,), generator=gen,
                                 dtype=torch.int64).tolist()
    return seed, offset


def step_generator(seed: int, step: int) -> torch.Generator:
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 32)
                                         | int(words[1]))


def device_generator(gen: torch.Generator,
                     device: torch.device | str) -> torch.Generator:
    value = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(value)
