"""MNIST-scale convolutional VAE (counterpart of
``apv_tpu/models/conv_vae.py``).

Encoder: per width, a stride-2 3×3 conv and a 3×3 conv (28 -> 14 -> 7),
a dense trunk and a float32 (mean, logvar) head with the logvar
soft-bounded as 8·tanh(lv/8). Decoder: dense -> dense -> 7×7 map, then per
width (reversed) a nearest 2× upsample and two 3×3 convs, ending in a
float32 3×3 likelihood head (Bernoulli logits by default). Every
activation is the configured one (tanh-GELU by default).

Public functions take and return NHWC, as ``apv_tpu`` does. Inside,
tensors are NCHW in ``torch.channels_last`` memory. Two flatten orders
follow flax: the encoder flattens the 7×7 map in (h, w, c) order before
its Dense, and the decoder reads its second Dense's output as an (h, w, c)
map; both are permutes of the NCHW view, so the converted Dense rows line
up with flax's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch.models.common import (Conv, Dense, PriorMixin,
                                         get_activation,
                                         likelihood_out_params, make_prior)


def _to_nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class ConvEncoder(nn.Module):
    def __init__(self, z_dim: int, widths: Sequence[int] = (32, 64),
                 dense: int = 512,
                 image_shape: tuple[int, int, int] = (28, 28, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 activation: str = "gelu"):
        super().__init__()
        hh, ww, ch = image_shape
        self.act = get_activation(activation)
        convs = []
        for w in widths:
            # 'SAME' stride 2 pads (0, 1) on an even side (models/common.py)
            convs += [Conv(ch, w, 3, stride=2, dtype=dtype),
                      Conv(w, w, 3, dtype=dtype)]
            ch, hh, ww = w, -(-hh // 2), -(-ww // 2)
        self.convs = nn.ModuleList(convs)
        self.dense = Dense(hh * ww * ch, dense, dtype=dtype)
        self.head = Dense(dense, 2 * z_dim, dtype=torch.float32)

    def forward(self, x_nhwc: torch.Tensor):
        h = _to_nchw(x_nhwc)
        for conv in self.convs:
            h = self.act(conv(h))
        # flatten in flax's (h, w, c) order; a view in channels_last
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = self.act(self.dense(h))
        out = self.head(h.to(torch.float32))
        mean, logvar = out.chunk(2, dim=-1)
        # soft bound: hard clipping would kill the gradient
        logvar = 8.0 * torch.tanh(logvar / 8.0)
        return mean, logvar


class ConvDecoder(nn.Module):
    def __init__(self, z_dim: int,
                 image_shape: tuple[int, int, int] = (28, 28, 1),
                 widths: Sequence[int] = (64, 32), dense: int = 512,
                 out_params: int = 1, dtype: torch.dtype = torch.bfloat16,
                 activation: str = "gelu"):
        super().__init__()
        hh, ww, c = image_shape
        self.act = get_activation(activation)
        # as the reference: a 4× smaller map (two upsamples)
        self.h0, self.w0, self.c0 = hh // 4, ww // 4, widths[0]
        self.dense0 = Dense(z_dim, dense, dtype=dtype)
        self.dense1 = Dense(dense, self.h0 * self.w0 * widths[0], dtype=dtype)
        convs, ch = [], widths[0]
        for w in widths:
            convs += [Conv(ch, w, 3, dtype=dtype), Conv(w, w, 3, dtype=dtype)]
            ch = w
        self.convs = nn.ModuleList(convs)
        self.head = Conv(ch, c * out_params, 3, dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.act(self.dense0(z))
        h = self.act(self.dense1(h))
        # flax reshapes the Dense output as an NHWC map
        h = _to_nchw(h.reshape(-1, self.h0, self.w0, self.c0))
        for i in range(0, len(self.convs), 2):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = self.act(self.convs[i](h))
            h = self.act(self.convs[i + 1](h))
        out = self.head(h.to(torch.float32))
        return out.permute(0, 2, 3, 1)          # [B, H, W, C*out_params]


class ConvVAE(PriorMixin, nn.Module):
    """Conv encoder/decoder; likelihood Bernoulli over pixels by default.
    ``prior`` as ``ResNetVAE``'s."""

    def __init__(self, z_dim: int = 40, widths: Sequence[int] = (32, 64),
                 dense: int = 512,
                 image_shape: tuple[int, int, int] = (28, 28, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 likelihood: str = "bernoulli", activation: str = "gelu",
                 mix_components: int = 5, prior: str = "standard",
                 prior_flow_layers: int = 6, prior_flow_hidden: int = 64):
        super().__init__()
        self.z_dim = z_dim
        self.likelihood = likelihood
        self.image_shape = tuple(image_shape)
        self.encoder = ConvEncoder(z_dim, widths, dense, self.image_shape,
                                   dtype, activation)
        self.decoder = ConvDecoder(
            z_dim, self.image_shape, tuple(reversed(widths)), dense,
            likelihood_out_params(likelihood, mix_components), dtype,
            activation)
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
