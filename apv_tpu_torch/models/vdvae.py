"""VDVAE: the very deep hierarchical VAE of Child (2021), "Very Deep VAEs
Generalize Autoregressive Models and Can Outperform Them on Images" (arXiv
2011.10650; github.com/openai/vdvae, ``vae.py``), the port's ``vdvae``
family.

Layer equations (every conv has a bias; GELU is the exact erf form):

* ``Block(in, mid, out)``: h = c4(gelu(c3(gelu(c2(gelu(c1(gelu(x)))))))),
  c1 and c4 1×1, c2 and c3 3×3 where the resolution is above 2 (1×1
  otherwise); out = x + h if residual, else h; then an average pool by
  ``down`` if given.
* Encoder: a 3×3 conv from the image channels to ``width``, then the
  residual Blocks of ``enc_blocks`` (``rxn``: n Blocks at resolution r;
  ``rdk``: one Block that then pools by k), each width → width·multiple →
  width; it keeps the last activation at each resolution.
* Decoder: one ``DecBlock`` per entry of ``dec_blocks`` (``rmk``: a block
  at r that first adds the nearest upsample of the state at k). Each
  resolution's state starts from a learned bias [1, width, r, r]. With x
  the state and a the encoder's activation at r: (qm, qs) = enc-Block(
  [x, a]) (2·width → mid → 2Z); (pm, ps, xpp) = prior-Block(x) (width →
  mid → 2Z + width); x += xpp; z = qm + e^qs·ε and the KL to N(pm, e^ps)
  (``ops.reparam_prior_kl``); x += z_proj(z); x = resnet-Block(x).
* Head: x·gain + bias per channel at the image's resolution, then a 1×1
  conv to 10·K channels, PixelCNN++'s mixture of K discretized logistics
  (``core.distributions.pixelcnn_mixture_logpmf``).

The input is the levels scaled by (x − 120.63838)/64.16736, the target
(x − 127.5)/127.5. Layouts and precision follow the flagship's
(``resnet_vae.py``): NCHW in channels_last memory, float32 parameters,
convs computing in ``dtype`` (bfloat16), and the three float32 heads: the
enc-Block's last conv (qm, qs), the prior's last conv for its (pm, ps)
outputs (its xpp outputs in ``dtype``), and the mixture head.

``init_`` gives the published init's structure from a seed: PyTorch's
default conv init (kaiming-uniform, a = √5) with zero biases, the prior
branch's last conv zero, and the last conv of every residual Block (the
encoder's and the decoder's) and z_proj scaled by √(1/n), n the number of
blocks of their stack.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apv_tpu_torch import ops
from apv_tpu_torch.core.distributions import pixelcnn_mixture_logpmf
from apv_tpu_torch.models.common import Conv
from apv_tpu_torch.utils.logging import span

SHIFT, SCALE = -120.63838, 1.0 / 64.16736        # the input's scaling
SHIFT_LOSS, SCALE_LOSS = -127.5, 1.0 / 127.5     # the target's


def parse_blocks(s: str) -> list[tuple[int, int | None]]:
    """A block string -> [(resolution, k)]: ``rxn`` n × (r, None); ``rdk``
    and ``rmk`` (r, k); ``r`` (r, None)."""
    out: list[tuple[int, int | None]] = []
    for part in s.split(","):
        if "x" in part:
            res, n = part.split("x")
            out += [(int(res), None)] * int(n)
        elif "m" in part or "d" in part:
            res, k = part.split("m" if "m" in part else "d")
            out.append((int(res), int(k)))
        else:
            out.append((int(part), None))
    return out


def prepare(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 levels [B, H, W, C] -> (input, target), float32 NHWC."""
    x = image.to(torch.float32)
    return (x + SHIFT) * SCALE, (x + SHIFT_LOSS) * SCALE_LOSS


class PriorOut(nn.Module):
    """The prior branch's last 1×1 conv, one weight [2Z + width, mid]: its
    first 2Z outputs (pm, ps) computed in float32, the width after them
    (xpp) in ``dtype``."""

    def __init__(self, mid: int, zdim: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2 * zdim + width, mid, 1, 1))
        self.bias = nn.Parameter(torch.zeros(2 * zdim + width))
        self.k, self.dtype = 2 * zdim, dtype

    def forward(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        k, dt = self.k, self.dtype
        stats = F.conv2d(h.to(torch.float32), self.weight[:k], self.bias[:k])
        xpp = F.conv2d(h.to(dt), self.weight[k:].to(dt), self.bias[k:].to(dt))
        return stats, xpp


class Block(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, *, residual: bool,
                 use_3x3: bool, dtype: torch.dtype, down: int | None = None,
                 last: nn.Module | None = None):
        super().__init__()
        k = 3 if use_3x3 else 1
        self.c1 = Conv(cin, mid, 1, dtype=dtype)
        self.c2 = Conv(mid, mid, k, dtype=dtype)
        self.c3 = Conv(mid, mid, k, dtype=dtype)
        self.c4 = last if last is not None else Conv(mid, cout, 1,
                                                     dtype=dtype)
        self.residual, self.down = residual, down

    def forward(self, x: torch.Tensor):
        h = self.c3(F.gelu(self.c2(F.gelu(self.c1(F.gelu(x))))))
        out = self.c4(F.gelu(h))
        if self.residual:
            out = x + out
        if self.down is not None:
            out = F.avg_pool2d(out, self.down)
        return out


class Encoder(nn.Module):
    def __init__(self, width: int, mid: int, blocks: str, channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.in_conv = Conv(channels, width, 3, dtype=dtype)
        self.enc_blocks = nn.ModuleList(
            Block(width, mid, width, residual=True, use_3x3=res > 2,
                  dtype=dtype, down=down)
            for res, down in parse_blocks(blocks))

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = self.in_conv(x)
        acts = {x.shape[2]: x}
        for block in self.enc_blocks:
            x = block(x)
            acts[x.shape[2]] = x
        return acts


class DecBlock(nn.Module):
    def __init__(self, res: int, mixin: int | None, width: int, mid: int,
                 zdim: int, dtype: torch.dtype):
        super().__init__()
        use_3x3 = res > 2
        self.base, self.mixin, self.dtype = res, mixin, dtype
        self.enc = Block(2 * width, mid, 2 * zdim, residual=False,
                         use_3x3=use_3x3, dtype=dtype,
                         last=Conv(mid, 2 * zdim, 1, dtype=torch.float32))
        self.prior = Block(width, mid, 2 * zdim + width, residual=False,
                           use_3x3=use_3x3, dtype=dtype,
                           last=PriorOut(mid, zdim, width, dtype))
        self.z_proj = Conv(zdim, width, 1, dtype=dtype)
        self.resnet = Block(width, mid, width, residual=True,
                            use_3x3=use_3x3, dtype=dtype)

    def forward(self, xs: dict, acts: dict, bias: torch.Tensor, *,
                generator=None, eps=None) -> torch.Tensor:
        """Update ``xs`` (the state by resolution) in place; the layer's
        per-image KL [B]."""
        a = acts[self.base]
        x = xs.get(self.base)
        if x is None:
            x = bias.to(self.dtype).expand(a.shape[0], -1, -1, -1)
        if self.mixin is not None:
            x = x + F.interpolate(xs[self.mixin][:, :x.shape[1]],
                                  scale_factor=self.base // self.mixin)
        q = self.enc(torch.cat([x, a], dim=1))
        stats, xpp = self.prior(x)
        x = x + xpp
        z, kl = ops.reparam_prior_kl(q, stats, generator=generator, eps=eps)
        x = x + self.z_proj(z)
        xs[self.base] = self.resnet(x)
        return kl


class Decoder(nn.Module):
    def __init__(self, width: int, mid: int, zdim: int, blocks: str,
                 image_size: int, mixtures: int, dtype: torch.dtype):
        super().__init__()
        parsed = parse_blocks(blocks)
        self.resolutions = sorted({res for res, _ in parsed})
        self.dec_blocks = nn.ModuleList(
            DecBlock(res, mixin, width, mid, zdim, dtype)
            for res, mixin in parsed)
        self.bias_xs = nn.ParameterList(
            nn.Parameter(torch.zeros(1, width, r, r))
            for r in self.resolutions)
        self.gain = nn.Parameter(torch.ones(1, width, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, width, 1, 1))
        self.out_net = nn.Module()
        self.out_net.out_conv = Conv(width, 10 * mixtures, 1,
                                     dtype=torch.float32)
        self.image_size = image_size

    def topdown(self, acts: dict, *, generator=None, eps=None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """(the state at the image's resolution, the layers' KLs [B] in
        order); ``eps`` (CPU only) a list of each layer's noise."""
        xs: dict = {}
        bias = dict(zip(self.resolutions, self.bias_xs))
        kls = [block(xs, acts, bias[block.base], generator=generator,
                     eps=None if eps is None else eps[i])
               for i, block in enumerate(self.dec_blocks)]
        return xs[self.image_size], kls

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The mixture's parameters [B, H, W, 10·K], float32."""
        x = x.to(torch.float32) * self.gain + self.bias
        return self.out_net.out_conv(x).permute(0, 2, 3, 1)


class VDVAE(nn.Module):
    """Encoder, top-down decoder and mixture head (module docstring)."""

    def __init__(self, *, width: int = 384, zdim: int = 16,
                 bottleneck_multiple: float = 0.25,
                 enc_blocks: str = "32x11,32d2,16x6,16d2,8x6,8d2,4x3,4d4,1x3",
                 dec_blocks: str = ("1x1,4m1,4x2,8m4,8x5,16m8,16x10,32m16,"
                                    "32x21"),
                 mixtures: int = 10,
                 image_shape: tuple[int, int, int] = (32, 32, 3),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = int(width * bottleneck_multiple)
        self.image_shape = tuple(image_shape)
        self.zdim = zdim
        self.encoder = Encoder(width, mid, enc_blocks, image_shape[2], dtype)
        self.decoder = Decoder(width, mid, zdim, dec_blocks, image_shape[0],
                               mixtures, dtype)

    @property
    def layers(self) -> int:
        """The stochastic layers, each drawing from its own key."""
        return len(self.decoder.dec_blocks)

    def forward(self, x_in: torch.Tensor, x_target: torch.Tensor, *,
                generator=None, eps=None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """(distortion [B], the layers' KLs [B] each), in nats; x_in and
        x_target NHWC float32 as ``prepare`` gives them."""
        x = x_in.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with span("model.encoder", marks="both"):
            acts = self.encoder(x)
        with span("model.topdown", marks="timed"):
            top, kls = self.decoder.topdown(acts, generator=generator,
                                            eps=eps)
        with span("model.head"):
            l = self.decoder.head(top)
            distortion = -pixelcnn_mixture_logpmf(x_target, l)
        return distortion, kls

    @torch.no_grad()
    def init_(self, seed: int) -> "VDVAE":
        """The published init's structure, drawn from numpy's
        ``default_rng(seed)``: weights U(±1/√fan_in) (PyTorch's default,
        kaiming-uniform with a = √5), biases zero, the prior's last conv
        zero, each residual Block's last conv and each z_proj times
        √(1/n) for the n blocks of its stack."""
        rng = np.random.default_rng(seed)
        for m in self.modules():
            if isinstance(m, (Conv, PriorOut)):
                w = m.weight
                bound = 1.0 / math.sqrt(math.prod(w.shape[1:]))
                w.copy_(torch.from_numpy(rng.uniform(-bound, bound,
                                                     w.shape)))
                m.bias.zero_()
        for stack in (self.encoder.enc_blocks, self.decoder.dec_blocks):
            scale = math.sqrt(1.0 / len(stack))
            for b in stack:
                if isinstance(b, DecBlock):
                    b.prior.c4.weight.zero_()
                    b.z_proj.weight.mul_(scale)
                    b.resnet.c4.weight.mul_(scale)
                else:
                    b.c4.weight.mul_(scale)
        return self
