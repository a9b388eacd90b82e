"""Plain float32 networks of the benchmarked configurations.

These are the benchmark's own reference: written from the architecture's
description in plain ``torch`` operations, with no kernel, no bfloat16 and
nothing imported from the program under test. Their parameter names are
those of the program's ``state_dict``, so one set of seeded weights can be
handed to both sides (``harness/seeded.py``).

The ResNet VAE (CIFAR-10): a 3×3 stem, per width two pre-norm residual
blocks (RMSNorm over channels, eps 1e-6, then the activation and a 3×3
conv, twice) and a stride-2 3×3 downsample between widths, then RMSNorm,
the activation and a Dense head to (mean, logvar) on the map flattened in
(h, w, c) order, logvar bounded as 8·tanh(lv/8). The decoder is a Dense to
the smallest map read in (h, w, c) order, the same blocks per width
(deepest first) with a stride-2 4×4 transposed conv between widths, then
RMSNorm, the activation and a 3×3 head to (mean, log_scale) a channel.
The conv VAE (MNIST): per width a stride-2 3×3 conv and a 3×3 conv, a
Dense trunk, the Dense head; the decoder two Dense layers to a 7×7 map,
per width a nearest 2× upsample and two 3×3 convs, a 3×3 head of logits.
The latent D is an MLP with LeakyReLU(0.2), whose derivative at 0 is 1.
Padding is XLA's 'SAME': symmetric at stride 1, (0, 1) at stride 2 on an
even side.

``Precision`` says how the operands of each product are rounded: not at
all (the reference), as the configuration states (``stated``: bfloat16
where it computes in bfloat16), or one step below that (the control:
float8 e4m3 with a per-tensor scale where the configuration computes in
bfloat16, bfloat16 where it computes in float32), with the gradient
passed straight through the rounding.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_FP8_MAX = 448.0          # largest finite float8 e4m3fn


class Precision:
    """Rounding of a product's operands by their role: ``low`` for the
    layers the configuration computes in bfloat16, ``f32`` for those it
    computes in float32. Mode ``f32`` rounds nothing; mode ``stated``
    rounds ``low`` operands to bfloat16; mode ``control`` rounds ``low``
    operands to float8 e4m3 (per-tensor scale) and ``f32`` operands to
    bfloat16."""

    MODES = ("f32", "stated", "control")

    def __init__(self, mode: str = "f32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown precision {mode!r}; have {self.MODES}")
        self.mode = mode

    def __call__(self, t: torch.Tensor, role: str) -> torch.Tensor:
        if self.mode == "f32" or (self.mode == "stated" and role != "low"):
            return t
        if role == "low" and self.mode == "control":
            amax = t.detach().abs().amax()
            scale = torch.where(amax > 0, amax / _FP8_MAX,
                                torch.ones_like(amax))
            q = (t.detach() / scale).to(torch.float8_e4m3fn).to(
                torch.float32) * scale
        else:
            q = t.detach().to(torch.bfloat16).to(torch.float32)
        return t + (q - t.detach())


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, prec: Precision,
                 role: str):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))
        self.prec, self.role = prec, role

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.prec
        return F.linear(p(x, self.role), p(self.weight, self.role),
                        self.bias)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, prec: Precision,
                 role: str, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        self.kernel, self.stride = kernel, stride
        self.prec, self.role = prec, role

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pads(x.shape[2], self.kernel, self.stride)
        pw = _same_pads(x.shape[3], self.kernel, self.stride)
        x = F.pad(self.prec(x, self.role), (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.prec(self.weight, self.role), self.bias,
                        stride=self.stride)


class ConvTranspose2x(nn.Module):
    """4×4 stride-2 transposed conv, 'SAME': output twice the input."""

    def __init__(self, cin: int, cout: int, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.empty(cout))
        self.prec = prec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(self.prec(x, "low"),
                                  self.prec(self.weight, "low"), self.bias,
                                  stride=2, padding=1)


class RMSNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ms = x.square().mean(dim=1, keepdim=True)
        return x * torch.rsqrt(ms + 1e-6) * self.weight.view(1, -1, 1, 1)


ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda x: F.gelu(x, approximate="tanh")}


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


class ResBlock(nn.Module):
    def __init__(self, cin: int, width: int, act, prec: Precision):
        super().__init__()
        self.act = act
        self.norm1 = RMSNorm(cin)
        self.conv1 = Conv(cin, width, 3, prec, "low")
        self.norm2 = RMSNorm(width)
        self.conv2 = Conv(width, width, 3, prec, "low")
        self.shortcut = (Conv(cin, width, 1, prec, "low") if cin != width
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.act(self.norm1(x)))
        h = self.conv2(self.act(self.norm2(h)))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class Stage(nn.Module):
    def __init__(self, blocks: list[ResBlock], resample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.resample = resample

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            h = block(h)
        return h if self.resample is None else self.resample(h)


class ResNetEncoder(nn.Module):
    def __init__(self, z_dim, widths, blocks, image_shape, act, prec):
        super().__init__()
        hh, ww, c = image_shape
        self.act = act
        self.stem = Conv(c, widths[0], 3, prec, "low")
        stages, ch = [], widths[0]
        for i, w in enumerate(widths):
            bl = []
            for _ in range(blocks):
                bl.append(ResBlock(ch, w, act, prec))
                ch = w
            down = None
            if i < len(widths) - 1:
                down = Conv(w, widths[i + 1], 3, prec, "low", stride=2)
                ch = widths[i + 1]
            stages.append(Stage(bl, down))
        self.stages = nn.ModuleList(stages)
        self.norm = RMSNorm(widths[-1])
        f = 2 ** (len(widths) - 1)
        self.head = Dense((hh // f) * (ww // f) * widths[-1], 2 * z_dim,
                          prec, "f32")

    def forward(self, x_nhwc: torch.Tensor):
        h = self.stem(x_nhwc.permute(0, 3, 1, 2))
        for stage in self.stages:
            h = stage(h)
        h = self.act(self.norm(h))
        mean, logvar = self.head(
            h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)).chunk(2, dim=-1)
        return mean, 8.0 * torch.tanh(logvar / 8.0)


class ResNetDecoder(nn.Module):
    def __init__(self, z_dim, widths, blocks, image_shape, out_params, act,
                 prec):
        super().__init__()
        hh, ww, c = image_shape
        f = 2 ** (len(widths) - 1)
        self.h0, self.w0, self.c0 = hh // f, ww // f, widths[0]
        self.act = act
        self.dense = Dense(z_dim, self.h0 * self.w0 * widths[0], prec, "low")
        stages = []
        for i, w in enumerate(widths):
            up = (ConvTranspose2x(w, widths[i + 1], prec)
                  if i < len(widths) - 1 else None)
            stages.append(Stage([ResBlock(w, w, act, prec)
                                 for _ in range(blocks)], up))
        self.stages = nn.ModuleList(stages)
        self.norm = RMSNorm(widths[-1])
        self.head = Conv(widths[-1], c * out_params, 3, prec, "f32")

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dense(z).reshape(-1, self.h0, self.w0, self.c0)
        h = h.permute(0, 3, 1, 2)
        for stage in self.stages:
            h = stage(h)
        return self.head(self.act(self.norm(h))).permute(0, 2, 3, 1)


class ConvEncoder(nn.Module):
    def __init__(self, z_dim, widths, dense, image_shape, act, prec):
        super().__init__()
        hh, ww, ch = image_shape
        self.act = act
        convs = []
        for w in widths:
            convs += [Conv(ch, w, 3, prec, "low", stride=2),
                      Conv(w, w, 3, prec, "low")]
            ch, hh, ww = w, -(-hh // 2), -(-ww // 2)
        self.convs = nn.ModuleList(convs)
        self.dense = Dense(hh * ww * ch, dense, prec, "low")
        self.head = Dense(dense, 2 * z_dim, prec, "f32")

    def forward(self, x_nhwc: torch.Tensor):
        h = x_nhwc.permute(0, 3, 1, 2)
        for conv in self.convs:
            h = self.act(conv(h))
        h = self.act(self.dense(h.permute(0, 2, 3, 1).reshape(h.shape[0],
                                                               -1)))
        mean, logvar = self.head(h).chunk(2, dim=-1)
        return mean, 8.0 * torch.tanh(logvar / 8.0)


class ConvDecoder(nn.Module):
    def __init__(self, z_dim, widths, dense, image_shape, out_params, act,
                 prec):
        super().__init__()
        hh, ww, c = image_shape
        self.act = act
        self.h0, self.w0, self.c0 = hh // 4, ww // 4, widths[0]
        self.dense0 = Dense(z_dim, dense, prec, "low")
        self.dense1 = Dense(dense, self.h0 * self.w0 * widths[0], prec, "low")
        convs, ch = [], widths[0]
        for w in widths:
            convs += [Conv(ch, w, 3, prec, "low"), Conv(w, w, 3, prec, "low")]
            ch = w
        self.convs = nn.ModuleList(convs)
        self.head = Conv(ch, c * out_params, 3, prec, "f32")

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.act(self.dense1(self.act(self.dense0(z))))
        h = h.reshape(-1, self.h0, self.w0, self.c0).permute(0, 3, 1, 2)
        for i in range(0, len(self.convs), 2):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = self.act(self.convs[i + 1](self.act(self.convs[i](h))))
        return self.head(h).permute(0, 2, 3, 1)


class VAE(nn.Module):
    """``encoder`` and ``decoder`` of one family, as the program names
    them."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def encode(self, x: torch.Tensor):
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


class LatentD(nn.Module):
    def __init__(self, z_dim: int, widths: Sequence[int], prec: Precision):
        super().__init__()
        dims = [z_dim, *widths, 1]
        self.layers = nn.ModuleList(Dense(a, b, prec, "f32")
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.layers[:-1]:
            h = leaky_relu(layer(h))
        return self.layers[-1](h)[..., 0]


OUT_PARAMS = {"bernoulli": 1, "discretized_logistic": 2}


def build_vae(model_cfg: dict, prec: Precision | None = None) -> VAE:
    """The VAE of a configuration's ``model`` section (a dict as the
    configuration file holds it)."""
    prec = prec or Precision()
    m = model_cfg
    if m.get("prior", "standard") != "standard":
        raise ValueError("the reference covers the standard prior only")
    act = ACTIVATIONS[m["activation"]]
    shape = tuple(m["image_shape"])
    out = OUT_PARAMS[m["likelihood"]]
    widths = tuple(m["widths"])
    if m["family"] == "resnet":
        if m["norm"] != "rms" or m["upsample"] != "conv_transpose":
            raise ValueError("the reference ResNet has RMSNorm and a "
                             "transposed-conv decoder")
        return VAE(ResNetEncoder(m["z_dim"], widths, m["blocks_per_stage"],
                                 shape, act, prec),
                   ResNetDecoder(m["z_dim"], widths[::-1],
                                 m["blocks_per_stage"], shape, out, act,
                                 prec))
    if m["family"] == "conv":
        return VAE(ConvEncoder(m["z_dim"], widths, m["dense"], shape, act,
                               prec),
                   ConvDecoder(m["z_dim"], widths[::-1], m["dense"], shape,
                               out, act, prec))
    raise ValueError(f"unknown family {m['family']!r}")


def build_latent_d(cfg: dict, prec: Precision | None = None) -> LatentD:
    a = cfg["adversarial"]
    if a.get("d_spectral_norm") or a.get("variant") != "learned_prior":
        raise ValueError("the reference covers the plain learned-prior D")
    return LatentD(cfg["model"]["z_dim"], a["d_widths"], prec or Precision())


def fan_in(name: str, shape: Sequence[int]) -> int:
    """A kernel's fan-in: [out, in] Dense, [out, in, kh, kw] conv, [in,
    out, kh, kw] transposed conv (the decoder's resampling layers)."""
    if len(shape) == 2:
        return shape[1]
    if ".resample." in name and name.startswith("decoder."):
        return shape[0] * shape[2] * shape[3]
    return math.prod(shape[1:])
