"""The discriminators (counterpart of ``apv_tpu/models/discriminator.py``).

* ``LatentDiscriminator``: an MLP on z giving one real/fake logit, float32
  throughout, LeakyReLU 0.2. Its logit is the density ratio the learned
  prior adds to the ELBO. With ``spectral_norm`` its layers are
  ``SNDense``.
* ``PixelDiscriminator``: the biadversarial variant's D_x(x), strided 4×4
  convs with LeakyReLU 0.2 computed in bf16 (float32 weights), then a
  float32 Dense to one logit, on images in the target space ([0, 1]
  levels or binary pixels), NHWC at its edges.

A biadversarial run keeps both in one ``nn.ModuleDict`` ``{"latent",
"pixel"}``; ``latent_d_params`` is the route every consumer of the
density-ratio D goes through.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch.models.common import Conv, Dense, lecun_normal_init_
from apv_tpu_torch.utils import jax_prng
from apv_tpu_torch.utils.device import resolve_device
from apv_tpu_torch.utils.logging import upload


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """flax's ``nn.leaky_relu``, whose derivative at 0 is 1 (torch's is the
    slope): binary images give the pixel D exact zeros, and its R1 penalty
    reads that derivative."""
    return torch.where(x >= 0, x, negative_slope * x)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SNDense(Dense):
    """``Dense`` applying W/σ(W), float32, with σ from ``n_iter`` power
    iterations started at a fixed vector: the reference's
    ``jax.random.normal(PRNGKey(d_in·31 + features), (d_in,))``, reproduced
    by ``utils/jax_prng``. Stateless: u and v carry no gradient and are not
    kept between calls (the iteration runs without autograd); the gradient
    reaches W through x·W/σ and σ = vᵀWu. σ is floored at 1e-12, so the
    zero kernel gives the zero map."""

    def __init__(self, in_features: int, out_features: int,
                 n_iter: int = 5):
        super().__init__(in_features, out_features)
        self.n_iter = n_iter
        start = jax_prng.normal(in_features * 31 + out_features, in_features)
        self.register_buffer("v0", torch.from_numpy(start), persistent=False)

    def sigma(self) -> torch.Tensor:
        kernel = self.weight.t()                       # flax's [in, out]
        with torch.no_grad():
            v = _unit(self.v0)
            u = kernel.t() @ v
            for _ in range(self.n_iter):
                v = _unit(kernel @ _unit(u))
                u = kernel.t() @ v
            u = _unit(u)
        return torch.clamp_min(v @ kernel @ u, 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(torch.float32), self.weight / self.sigma(),
                        self.bias)


class LatentDiscriminator(nn.Module):
    def __init__(self, z_dim: int, widths: Sequence[int] = (256, 256),
                 negative_slope: float = 0.2, spectral_norm: bool = False):
        super().__init__()
        dense = SNDense if spectral_norm else Dense
        dims = [z_dim, *widths, 1]
        self.layers = nn.ModuleList(dense(a, b) for a, b in zip(dims,
                                                                 dims[1:]))
        self.negative_slope = negative_slope

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(torch.float32)
        for layer in self.layers[:-1]:
            h = leaky_relu(layer(h), self.negative_slope)
        return self.layers[-1](h)[..., 0]        # [B] logits


class PixelDiscriminator(nn.Module):
    """D_x on NHWC images [B, H, W, C] -> logits [B]. Each stage is a 4×4
    stride-2 conv with flax's 'SAME' pads (28 -> 14 -> 7 -> 4 pads the last
    stage (1, 2)). The head flattens the last map in (h, w, c) order, as
    flax flattens NHWC, so a converted Dense kernel needs no permute."""

    def __init__(self, image_shape: Sequence[int],
                 widths: Sequence[int] = (32, 64, 128),
                 negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        h, w, c = image_shape
        chans = [c, *widths]
        self.convs = nn.ModuleList(Conv(a, b, 4, 2, dtype=dtype)
                                   for a, b in zip(chans, chans[1:]))
        for _ in widths:
            h, w = -(-h // 2), -(-w // 2)
        self.head = Dense(h * w * chans[-1], 1)
        self.negative_slope = negative_slope
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        for conv in self.convs:
            h = leaky_relu(conv(h), self.negative_slope)
        flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.head(flat.to(torch.float32))[..., 0]   # [B] logits


def make_latent_d(adv_cfg, z_dim: int, *, device=None,
                  seed: int = 1) -> LatentDiscriminator:
    """The latent D for an AdversarialConfig (widths, spectral norm),
    seeded lecun-normal init, on ``device`` (``None``: the CUDA card,
    raising if there is none)."""
    dev = resolve_device(device)
    disc = LatentDiscriminator(z_dim, tuple(adv_cfg.d_widths),
                               spectral_norm=adv_cfg.d_spectral_norm)
    return upload(lecun_normal_init_(disc, seed), device=dev)


def make_discriminators(adv_cfg, z_dim: int, image_shape: Sequence[int], *,
                        device=None, seed: int = 1,
                        dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A run's D: the latent D, or under ``variant='biadversarial'`` the
    ``ModuleDict`` of the latent D and the pixel D (its convs computing in
    ``dtype``), the pixel D seeded from a second numpy stream of
    ``seed``."""
    latent = make_latent_d(adv_cfg, z_dim, device=device, seed=seed)
    if adv_cfg.variant != "biadversarial":
        return latent
    pixel = PixelDiscriminator(image_shape, tuple(adv_cfg.pixel_d_widths),
                               dtype=dtype)
    lecun_normal_init_(pixel, [seed, 1])
    return nn.ModuleDict({"latent": latent,
                          "pixel": upload(pixel, device=latent.layers[0]
                                          .weight.device)})


def latent_d_params(variant: str, d):
    """The latent D of a run's D (None stays None): the ``"latent"`` entry
    under the biadversarial variant, ``d`` itself otherwise."""
    if variant == "biadversarial" and isinstance(d, nn.ModuleDict):
        return d["latent"]
    return d
