"""Latent-space discriminator D(z) (counterpart of
``apv_tpu/models/discriminator.py``).

An MLP on z giving one real/fake logit, float32 throughout, LeakyReLU 0.2.
Its logit is the density ratio the learned prior adds to the ELBO.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch.models.common import Dense, lecun_normal_init_
from apv_tpu_torch.utils.device import resolve_device


class LatentDiscriminator(nn.Module):
    def __init__(self, z_dim: int, widths: Sequence[int] = (256, 256),
                 negative_slope: float = 0.2, spectral_norm: bool = False):
        super().__init__()
        if spectral_norm:
            raise NotImplementedError(
                "the spectrally normalized latent D (SNDense) is not "
                "ported yet; set adversarial.d_spectral_norm=False")
        dims = [z_dim, *widths, 1]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims, dims[1:]))
        self.negative_slope = negative_slope

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(torch.float32)
        for layer in self.layers[:-1]:
            h = F.leaky_relu(layer(h), self.negative_slope)
        return self.layers[-1](h)[..., 0]        # [B] logits


def make_latent_d(adv_cfg, z_dim: int, *, device=None,
                  seed: int = 1) -> LatentDiscriminator:
    """The latent D for an AdversarialConfig, seeded lecun-normal init, on
    ``device`` (``None``: the CUDA card, raising if there is none)."""
    dev = resolve_device(device)
    disc = LatentDiscriminator(z_dim, tuple(adv_cfg.d_widths),
                               spectral_norm=adv_cfg.d_spectral_norm)
    return lecun_normal_init_(disc, seed).to(dev)
