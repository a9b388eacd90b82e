"""Shared network pieces: the activation registry, flax-equivalent layers
and the seeded initializer (counterpart of ``apv_tpu/models/common.py``).

Layers keep float32 parameters and compute in a ``dtype`` (bf16 by
default, as flax's ``dtype`` attribute does): inputs, kernels and biases
are cast to it at each call. Tensors are NCHW in ``torch.channels_last``
memory, so every NHWC view at the model's edges is free.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch.core.distributions import standard_gaussian_logpdf
from apv_tpu_torch.models.flow_prior import FlowPrior
from apv_tpu_torch.models.gaussian_prior import GaussianPrior

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    # flax's default gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_sigmoid": lambda x: x * torch.sigmoid(1.702 * x),
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; "
                         f"have {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def likelihood_out_params(likelihood: str, mix_components: int) -> int:
    """Per-image-channel decoder head width: Bernoulli logits (1),
    disc-logistic (mean, log_scale -> 2), K-component mixture (3·K)."""
    if likelihood == "bernoulli":
        return 1
    if likelihood == "discretized_logistic":
        return 2
    if likelihood == "disc_logistic_mix":
        return 3 * mix_components
    raise ValueError(f"unknown likelihood {likelihood!r}")


# ---------------------------------------------------------------------------
# flax-equivalent layers
# ---------------------------------------------------------------------------

def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA 'SAME' padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ W + b, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding on NCHW tensors.

    Stride 1 pads symmetrically; the stride-2 3×3 downsample pads (0, 1) on
    each spatial axis, as XLA's 'SAME' does for an even input.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pads(x.shape[2], self.kernel, self.stride)
        pw = _same_pads(x.shape[3], self.kernel, self.stride)
        x = x.to(self.dtype)
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, b, stride=self.stride, padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, stride=self.stride)


class ConvTranspose2x(nn.Module):
    """flax ``nn.ConvTranspose((4, 4), strides=(2, 2), padding='SAME')``.

    Equal to ``F.conv_transpose2d(stride=2, padding=1)`` once the flax
    kernel is flipped spatially and laid out (in, out, kh, kw) — the
    converter does that; ``weight`` here is already in torch's layout.
    """

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 4, 4))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2,
                                  padding=1)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` over the channel axis: eps 1e-6, one ``scale``,
    float32 statistics, output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        ms = x32.square().mean(dim=1, keepdim=True)
        y = x32 * (torch.rsqrt(ms + 1e-6) * self.weight.view(1, -1, 1, 1))
        return y.to(self.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=8)``: eps 1e-6, float32 statistics,
    ``scale`` and ``bias``, output in ``dtype``."""

    def __init__(self, channels: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.dtype = groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.to(torch.float32), self.groups, self.weight,
                         self.bias, eps=1e-6)
        return y.to(self.dtype)


def make_norm(norm: str, channels: int, dtype: torch.dtype,
              groups: int = 8) -> nn.Module:
    """'group' -> GroupNorm, 'rms' -> channel RMSNorm, 'none' -> identity."""
    if norm == "group":
        return GroupNorm(channels, groups, dtype)
    if norm == "rms":
        return RMSNorm(channels, dtype)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r} (group|rms|none)")


# ---------------------------------------------------------------------------
# the model's own prior
# ---------------------------------------------------------------------------

def make_prior(prior: str, z_dim: int, flow_layers: int = 6,
               flow_hidden: int = 64) -> nn.Module | None:
    """'standard' -> None (N(0, I)), 'gaussian' -> ``GaussianPrior``,
    'flow' -> ``FlowPrior``. Its parameters are float32 and it computes in
    float32 whatever the model's dtype, as the reference's prior does."""
    if prior == "standard":
        return None
    if prior == "gaussian":
        return GaussianPrior(z_dim)
    if prior == "flow":
        return FlowPrior(z_dim, flow_layers, flow_hidden)
    raise ValueError(f"unknown model prior {prior!r} (standard|flow|gaussian)")


class PriorMixin:
    """``prior_logpdf`` and ``prior_sample_from`` of a VAE whose
    ``self.prior`` is ``make_prior``'s module (None: N(0, I))."""

    def prior_logpdf(self, z: torch.Tensor, *,
                     detach_params: bool = False) -> torch.Tensor:
        """log p(z) under the model's own prior, shape ``z.shape[:-1]``,
        exact for every family (the adversarially shaped prior is not a
        model prior: it lives in D and carries a log Z)."""
        if self.prior is None:
            return torch.sum(standard_gaussian_logpdf(z), dim=-1)
        return self.prior(z, detach_params=detach_params)

    def prior_sample_from(self, u: torch.Tensor) -> torch.Tensor:
        """Base draws u ~ N(0, I) -> prior draws (the identity for the
        standard prior)."""
        return u if self.prior is None else self.prior.sample_from(u)


# ---------------------------------------------------------------------------
# seeded init
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978      # std of N(0,1) truncated to [-2, 2]


def lecun_normal_init_(module: nn.Module, seed: int) -> nn.Module:
    """flax's default init, from numpy so a seed gives the same weights on
    any machine: kernels lecun-normal (truncated normal, variance 1/fan_in),
    biases zero, norm scales one. ``Linear``-style weights are (out, in),
    conv (out, in, kh, kw), conv-transpose (in, out, kh, kw)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, (Dense, Conv, ConvTranspose2x)):
                w = layer.weight
                if isinstance(layer, ConvTranspose2x):
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = math.prod(w.shape[1:])
                draw = rng.standard_normal(w.shape)
                bad = np.abs(draw) > 2.0
                while bad.any():
                    draw[bad] = rng.standard_normal(int(bad.sum()))
                    bad = np.abs(draw) > 2.0
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w.copy_(torch.from_numpy(draw * std))
                layer.bias.zero_()
    return module
