"""CIFAR-scale residual VAE (counterpart of ``apv_tpu/models/resnet_vae.py``).

Encoder: conv stem -> [ResBlock × n, stride-2 downsample] per stage
(32 -> 16 -> 8), then norm and activation (one module, ``make_norm``) and
a float32 Gaussian head on the flattened map. The decoder mirrors it with
stride-2 4×4 transposed convs (or nearest upsample + conv) and ends in a
float32 likelihood head of (mean, log_scale) per pixel channel.

Public functions take and return NHWC, as ``apv_tpu`` does. Inside, tensors
are NCHW in ``torch.channels_last`` memory, so each NHWC<->NCHW permute is
a view. Two flatten orders follow flax: the encoder flattens the map in
(h, w, c) order before its head, and the decoder reads its Dense output as
an (h, w, c) map.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch.models.common import (Conv, ConvTranspose2x, Dense,
                                         PriorMixin, likelihood_out_params,
                                         make_norm, make_prior)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, width: int, dtype: torch.dtype,
                 activation: str = "gelu", norm: str = "group"):
        super().__init__()
        self.norm1 = make_norm(norm, in_ch, dtype, activation)
        self.conv1 = Conv(in_ch, width, 3, dtype=dtype)
        self.norm2 = make_norm(norm, width, dtype, activation)
        self.conv2 = Conv(width, width, 3, dtype=dtype)
        self.shortcut = Conv(in_ch, width, 1, dtype=dtype) \
            if in_ch != width else None
        # norm-free blocks scale the residual branch by 1/sqrt(2)
        self.branch_scale = 2.0 ** -0.5 if norm == "none" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.branch_scale is not None:
            h = h * self.branch_scale
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Stage(nn.Module):
    """Residual blocks at one resolution, then the resampling layer."""

    def __init__(self, blocks: list[ResBlock], resample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.resample = resample

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            h = block(h)
        return h if self.resample is None else self.resample(h)


class NearestUp(nn.Module):
    """Nearest-neighbour 2x upsample followed by a 3×3 conv."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, 3, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(h, scale_factor=2, mode="nearest"))


class ResNetEncoder(nn.Module):
    def __init__(self, z_dim: int, widths: Sequence[int] = (64, 128, 256),
                 blocks_per_stage: int = 2,
                 image_shape: tuple[int, int, int] = (32, 32, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 activation: str = "gelu", norm: str = "group"):
        super().__init__()
        hh, ww, c = image_shape
        self.dtype = dtype
        self.stem = Conv(c, widths[0], 3, dtype=dtype)
        stages, ch = [], widths[0]
        for i, w in enumerate(widths):
            blocks = []
            for _ in range(blocks_per_stage):
                blocks.append(ResBlock(ch, w, dtype, activation, norm))
                ch = w
            down = None
            if i < len(widths) - 1:
                down = Conv(w, widths[i + 1], 3, stride=2, dtype=dtype)
                ch = widths[i + 1]
            stages.append(Stage(blocks, down))
        self.stages = nn.ModuleList(stages)
        self.norm = make_norm(norm, widths[-1], dtype, activation)
        down = 2 ** (len(widths) - 1)
        self.head = Dense((hh // down) * (ww // down) * widths[-1],
                          2 * z_dim, dtype=torch.float32)

    def forward(self, x_nhwc: torch.Tensor):
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.stem(x)
        for stage in self.stages:
            h = stage(h)
        h = self.norm(h)
        # flatten in flax's (h, w, c) order; a view in channels_last
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        out = self.head(h.to(torch.float32))
        mean, logvar = out.chunk(2, dim=-1)
        logvar = 8.0 * torch.tanh(logvar / 8.0)
        return mean, logvar


class ResNetDecoder(nn.Module):
    def __init__(self, z_dim: int,
                 image_shape: tuple[int, int, int] = (32, 32, 3),
                 widths: Sequence[int] = (256, 128, 64),   # deepest first
                 blocks_per_stage: int = 2, out_params: int = 2,
                 dtype: torch.dtype = torch.bfloat16,
                 activation: str = "gelu", norm: str = "group",
                 upsample: str = "nearest"):
        super().__init__()
        if upsample not in ("nearest", "conv_transpose"):
            raise ValueError(f"unknown upsample {upsample!r} "
                             "(nearest|conv_transpose)")
        hh, ww, c = image_shape
        down = 2 ** (len(widths) - 1)
        self.h0, self.w0, self.c0 = hh // down, ww // down, widths[0]
        self.dense = Dense(z_dim, self.h0 * self.w0 * widths[0], dtype=dtype)
        stages = []
        for i, w in enumerate(widths):
            blocks = [ResBlock(w, w, dtype, activation, norm)
                      for _ in range(blocks_per_stage)]
            up = None
            if i < len(widths) - 1:
                up = (ConvTranspose2x(w, widths[i + 1], dtype)
                      if upsample == "conv_transpose"
                      else NearestUp(w, widths[i + 1], dtype))
            stages.append(Stage(blocks, up))
        self.stages = nn.ModuleList(stages)
        self.norm = make_norm(norm, widths[-1], dtype, activation)
        self.head = Conv(widths[-1], c * out_params, 3, dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dense(z)
        # flax reshapes the Dense output as an NHWC map
        h = h.reshape(-1, self.h0, self.w0, self.c0).permute(0, 3, 1, 2)
        h = h.contiguous(memory_format=torch.channels_last)
        for stage in self.stages:
            h = stage(h)
        h = self.norm(h)
        out = self.head(h.to(torch.float32))
        return out.permute(0, 2, 3, 1)          # [B, H, W, C*out_params]


class ResNetVAE(PriorMixin, nn.Module):
    """Residual VAE; likelihood = discretized logistic (CIFAR-10). ``prior``
    is the model's own: 'standard' N(0, I), or a trained 'gaussian' base
    or 'flow', held in ``self.prior`` (``models/common.make_prior``)."""

    def __init__(self, z_dim: int = 128, widths: Sequence[int] = (64, 128, 256),
                 blocks_per_stage: int = 2,
                 image_shape: tuple[int, int, int] = (32, 32, 3),
                 dtype: torch.dtype = torch.bfloat16,
                 likelihood: str = "discretized_logistic",
                 upsample: str = "nearest", activation: str = "gelu",
                 norm: str = "group", mix_components: int = 5,
                 prior: str = "standard", prior_flow_layers: int = 6,
                 prior_flow_hidden: int = 64):
        super().__init__()
        self.z_dim = z_dim
        self.likelihood = likelihood
        self.image_shape = tuple(image_shape)
        self.encoder = ResNetEncoder(z_dim, widths, blocks_per_stage,
                                     self.image_shape, dtype, activation, norm)
        self.decoder = ResNetDecoder(
            z_dim, self.image_shape, tuple(reversed(widths)), blocks_per_stage,
            likelihood_out_params(likelihood, mix_components), dtype,
            activation, norm, upsample)
        self.prior = make_prior(prior, z_dim, prior_flow_layers,
                                prior_flow_hidden)

    def encode(self, x: torch.Tensor):
        """x [B, H, W, C] -> (mean, logvar), each f32 [B, Z]."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, Z] -> likelihood params f32 [B, H, W, C*out_params]."""
        return self.decoder(z)

    def forward(self, x: torch.Tensor, z: torch.Tensor):
        mean, logvar = self.encode(x)
        return mean, logvar, self.decode(z)
