"""Inputs and weights made from a run's ``--seed``, on the device, in a few
large calls: the same seed gives the same images and weights."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import fan_in


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    words = np.random.SeedSequence(
        [seed, *tag.encode()]).generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def weights(module: torch.nn.Module, seed: int, tag: str, device) -> dict:
    """Float32 weights for ``module``'s parameters, by name: kernels
    N(0, 2/fan_in) (He's gain, which keeps the activations' scale through
    the networks' rectifying activations, so outputs have the magnitude of
    a trained model's and not a vanishing one) from one draw of them all
    (the stream ``tag`` of the seed), biases 0, norm scales 1."""
    params = dict(module.named_parameters())
    kernels = {n: p for n, p in params.items() if p.dim() >= 2}
    total = sum(p.numel() for p in kernels.values())
    draw = torch.randn(total, generator=generator(seed, tag, device),
                       device=device)
    out, at = {}, 0
    for name, p in params.items():
        if p.dim() >= 2:
            w = draw[at:at + p.numel()].view(p.shape)
            out[name] = w * (2.0 / fan_in(name, p.shape)) ** 0.5
            at += p.numel()
        elif name.endswith("bias"):
            out[name] = torch.zeros(p.shape, device=device)
        else:
            out[name] = torch.ones(p.shape, device=device)
    return out


def images(count: int, shape, seed: int, tag: str, device, *,
           binary_p: float | None = None) -> torch.Tensor:
    """uint8 images [count, *shape]: levels uniform on 0..255, or with
    ``binary_p`` binary pixels that are 1 with that probability."""
    gen = generator(seed, tag, device)
    if binary_p is None:
        return torch.randint(0, 256, (count, *shape), generator=gen,
                             device=device, dtype=torch.uint8)
    u = torch.rand((count, *shape), generator=gen, device=device)
    return (u < binary_p).to(torch.uint8)
