"""VDVAE (Child 2021, arXiv 2011.10650; github.com/openai/vdvae ``vae.py``,
``vae_helpers.py`` and ``train.py``) in plain float32 torch: the forward
pass, the loss, its gradients and the published update.

Written from the published equations, with nothing of the program under
test imported; parameter names are those of the program's ``state_dict``,
so one set of seeded weights serves both sides.

* ``Block(in, mid, out)``: h = c4(gelu(c3(gelu(c2(gelu(c1(gelu(x))))))))
  (GELU's erf form), c1 and c4 1×1, c2 and c3 3×3 where the resolution is
  above 2 and 1×1 otherwise; x + h if residual; an average pool by ``down``.
* Encoder: a 3×3 conv to the width, the residual Blocks of the encoder's
  string (``rxn`` n blocks at r, ``rdk`` one block pooling by k), the last
  activation kept at each resolution.
* Decoder: one block per entry of the decoder's string (``rmk`` adds the
  nearest upsample of the state at k first); each resolution's state starts
  from its learned bias. (qm, qs) = enc-Block([x, a]); (pm, ps, xpp) =
  prior-Block(x); x += xpp; z = qm + e^qs·ε; kl = −½ + ps − qs + ½(e^{2qs}
  + (qm − pm)²)/e^{2ps}; x += z_proj(z); x = resnet-Block(x).
* Head: x·gain + bias, a 1×1 conv to 10·K, PixelCNN++'s discretized mixture
  of K logistics with coupled RGB means, log-scales floored at −7, edge bins
  at ±0.999 and the 1e-5 fallback to the log density less log 127.5.
* Loss: (distortion + Σ_layers Σ kl) / (H·W·C), the batch mean.
* Update (``train.py``): the global norm n of the gradients; each scaled by
  min(1, c/(n + 1e-6)) (``clip_grad_norm_``); skipped when n ≥ the
  threshold or the distortion or rate is NaN; otherwise ``torch.optim.
  AdamW``'s step written out (decoupled decay first, bias corrections from
  the count of applied steps) at the iteration's learning rate (linear
  warmup, then constant), then the EMA e ← e·d + θ·(1 − d).

Departures from the published code, none of which changes a value beyond
rounding: the ε of each layer comes from the program's stream (Philox, one
key a layer from the step's generator, in the order of z's channels_last
memory; ``stream.py``), not ``torch.randn``; the batch is split into
micro-batches whose gradients are summed (the float32 activations of 128
images do not fit a card), so the gradient is summed in another order; the
prior's last conv computes its (pm, ps) rows and its xpp rows as two convs
(so that ``Precision`` can round them as the program computes them); the
EMA is updated as e + (1 − d)·(θ − e), the published e·d + θ·(1 − d) in
another order, whose float32 rounding at d = 0.9999 is of the size of what
a few steps move the EMA.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import stream
from benchmark.reference.models import Precision
from benchmark.reference.train import batch_rows

SHIFT, SCALE = -120.63838, 1.0 / 64.16736
SHIFT_LOSS, SCALE_LOSS = -127.5, 1.0 / 127.5
MICRO = 32            # images a micro-batch
# AdamW's decoupled weight decay and the skip threshold of hps.py's cifar10
# setting, which the program's skipping AdamW holds as its own constants
WEIGHT_DECAY, SKIP_THRESHOLD = 0.01, 400.0


def parse_blocks(s: str) -> list[tuple[int, int | None]]:
    out = []
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


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, prec: Precision,
                 role: str):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.prec, self.role, self.pad = prec, role, k // 2

    def forward(self, x):
        p = self.prec
        return F.conv2d(p(x, self.role), p(self.weight, self.role),
                        self.bias, padding=self.pad)


class PriorOut(nn.Module):
    """The prior's last conv: rows [0, 2Z) (pm, ps) at float32, the rest
    (xpp) at the blocks' precision."""

    def __init__(self, mid: int, zdim: int, width: int, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2 * zdim + width, mid, 1, 1))
        self.bias = nn.Parameter(torch.empty(2 * zdim + width))
        self.k, self.prec = 2 * zdim, prec

    def forward(self, h):
        p, k = self.prec, self.k
        stats = F.conv2d(p(h, "f32"), p(self.weight[:k], "f32"),
                         self.bias[:k])
        xpp = F.conv2d(p(h, "low"), p(self.weight[k:], "low"), self.bias[k:])
        return stats, xpp


class Block(nn.Module):
    def __init__(self, cin, mid, cout, *, residual, use_3x3, prec,
                 down=None, last=None):
        super().__init__()
        k = 3 if use_3x3 else 1
        self.c1 = Conv(cin, mid, 1, prec, "low")
        self.c2 = Conv(mid, mid, k, prec, "low")
        self.c3 = Conv(mid, mid, k, prec, "low")
        self.c4 = last if last is not None else Conv(mid, cout, 1, prec,
                                                     "low")
        self.residual, self.down = residual, down

    def forward(self, x):
        h = self.c1(F.gelu(x))
        h = self.c2(F.gelu(h))
        h = self.c3(F.gelu(h))
        out = self.c4(F.gelu(h))
        if self.residual:
            out = x + out
        if self.down is not None:
            out = F.avg_pool2d(out, self.down)
        return out


class Encoder(nn.Module):
    def __init__(self, width, mid, blocks, channels, prec):
        super().__init__()
        self.in_conv = Conv(channels, width, 3, prec, "low")
        self.enc_blocks = nn.ModuleList(
            Block(width, mid, width, residual=True, use_3x3=res > 2,
                  prec=prec, down=down) for res, down in parse_blocks(blocks))

    def forward(self, x):
        x = self.in_conv(x)
        acts = {x.shape[2]: x}
        for b in self.enc_blocks:
            x = b(x)
            acts[x.shape[2]] = x
        return acts


class DecBlock(nn.Module):
    def __init__(self, res, mixin, width, mid, zdim, prec):
        super().__init__()
        u = res > 2
        self.base, self.mixin, self.zdim = res, mixin, zdim
        self.enc = Block(2 * width, mid, 2 * zdim, residual=False,
                         use_3x3=u, prec=prec,
                         last=Conv(mid, 2 * zdim, 1, prec, "f32"))
        self.prior = Block(width, mid, 2 * zdim + width, residual=False,
                           use_3x3=u, prec=prec,
                           last=PriorOut(mid, zdim, width, prec))
        self.z_proj = Conv(zdim, width, 1, prec, "low")
        self.resnet = Block(width, mid, width, residual=True, use_3x3=u,
                            prec=prec)

    def forward(self, xs, acts, bias, eps, kl_fault=None):
        a = acts[self.base]
        x = xs.get(self.base, bias.expand(a.shape[0], -1, -1, -1))
        if self.mixin is not None:
            x = x + F.interpolate(xs[self.mixin][:, :x.shape[1]],
                                  scale_factor=self.base // self.mixin)
        qm, qs = self.enc(torch.cat([x, a], dim=1)).chunk(2, dim=1)
        stats, xpp = self.prior(x)
        pm, ps = stats.chunk(2, dim=1)
        if kl_fault == "standard_prior":
            pm, ps = torch.zeros_like(pm), torch.zeros_like(ps)
        x = x + xpp
        z = qm + torch.exp(qs) * eps
        kl = (-0.5 + ps - qs + 0.5 * (torch.exp(qs) ** 2 + (qm - pm) ** 2)
              / torch.exp(ps) ** 2)
        x = x + self.z_proj(z)
        xs[self.base] = self.resnet(x)
        return kl.sum(dim=(1, 2, 3))


class VDVAE(nn.Module):
    def __init__(self, m: dict, prec: Precision):
        super().__init__()
        width, zdim = m["widths"][0], m["z_dim"]
        mid = int(width * m["bottleneck_multiple"])
        h, w, c = m["image_shape"]
        self.encoder = Encoder(width, mid, m["enc_blocks"], c, prec)
        dec = nn.Module()
        parsed = parse_blocks(m["dec_blocks"])
        dec.resolutions = sorted({r for r, _ in parsed})
        dec.dec_blocks = nn.ModuleList(DecBlock(r, k, width, mid, zdim, prec)
                                       for r, k in parsed)
        dec.bias_xs = nn.ParameterList(
            nn.Parameter(torch.empty(1, width, r, r))
            for r in dec.resolutions)
        dec.gain = nn.Parameter(torch.empty(1, width, 1, 1))
        dec.bias = nn.Parameter(torch.empty(1, width, 1, 1))
        dec.out_net = nn.Module()
        dec.out_net.out_conv = Conv(width, 10 * m["mix_components"], 1, prec,
                                    "f32")
        self.decoder = dec
        self.size = h

    def layer_shapes(self, batch: int) -> list[tuple[int, int, int, int]]:
        """z's shape [B, Z, r, r] in each layer, in order."""
        return [(batch, b.zdim, b.base, b.base)
                for b in self.decoder.dec_blocks]

    def forward(self, x_in, x_target, eps: list, kl_fault=None):
        """(distortion [B], the layers' KLs [L, B]) in nats."""
        acts = self.encoder(x_in.permute(0, 3, 1, 2))
        dec = self.decoder
        bias = dict(zip(dec.resolutions, dec.bias_xs))
        xs: dict = {}
        kls = torch.stack([b(xs, acts, bias[b.base], e, kl_fault)
                           for b, e in zip(dec.dec_blocks, eps)])
        x = xs[self.size] * dec.gain + dec.bias
        l = dec.out_net.out_conv(x).permute(0, 2, 3, 1)
        return -mixture_logpmf(x_target, l), kls


def mixture_logpmf(x, l):
    """``discretized_mix_logistic_loss`` of ``vae_helpers.py`` as a log
    probability: per image, the sum over pixels -> [B]."""
    xs = list(x.shape)
    nr_mix = l.shape[-1] // 10
    logit_probs = l[..., :nr_mix]
    l = l[..., nr_mix:].reshape(xs + [nr_mix * 3])
    means = l[..., :nr_mix]
    log_scales = torch.clamp(l[..., nr_mix:2 * nr_mix], min=-7.0)
    coeffs = torch.tanh(l[..., 2 * nr_mix:3 * nr_mix])
    x = x.reshape(xs + [1]) + torch.zeros(xs + [nr_mix], device=x.device)
    m2 = (means[..., 1, :] + coeffs[..., 0, :] * x[..., 0, :]).unsqueeze(3)
    m3 = (means[..., 2, :] + coeffs[..., 1, :] * x[..., 0, :]
          + coeffs[..., 2, :] * x[..., 1, :]).unsqueeze(3)
    means = torch.cat([means[..., 0, :].unsqueeze(3), m2, m3], dim=3)
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / 255.0)
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - 1.0 / 255.0)
    cdf_min = torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    log_probs = torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.clamp(cdf_delta, min=1e-12)),
                                log_pdf_mid - math.log(127.5))))
    log_probs = log_probs.sum(dim=3) + (
        logit_probs - torch.logsumexp(logit_probs, dim=-1, keepdim=True))
    return torch.logsumexp(log_probs, dim=-1).sum(dim=(1, 2))


def layer_noise(shapes, gen: torch.Generator, dev) -> list[torch.Tensor]:
    """Each layer's ε from its own key of the step's generator, laid out as
    z's channels_last memory [B, r, r, Z]."""
    out = []
    for b, z, h, w in shapes:
        seed, offset = stream.draw_key(gen)
        out.append(stream.normals(b * z * h * w, seed, offset, dev)
                   .reshape(b, h, w, z).permute(0, 3, 1, 2))
    return out


def lr_at(train: dict, iteration: int) -> float:
    """``linear_warmup``: lr·it/warmup up to the warmup, then lr."""
    warm = train["lr_warmup_steps"]
    return train["lr"] * (1.0 if iteration > warm else iteration / warm)


FAULTS = ("no_kl_grad", "kl_standard_prior", "state_unchanged",
          "ema_rate")


def follow(cfg: dict, weights: dict, images: torch.Tensor, steps: int,
           seed: int, prec: Precision | None = None, start: int = 0,
           rows: int | None = None, fault: str | None = None) -> dict:
    """Run ``steps`` steps from step ``start`` and ``weights`` on
    ``images`` (uint8 [N, H, W, C] on the computing device): AdamW's
    moments zero and its count at ``start``, as a run that took ``start``
    steps and skipped none has it, and the EMA at the weights.

    Planted faults: ``rows`` keeps the first ``rows`` images of each batch
    (after its noise is drawn); ``fault`` 'no_kl_grad' leaves the KL's
    gradient out (its value stays in the loss), 'kl_standard_prior' takes
    every layer's KL against N(0, I) instead of its learned prior,
    'state_unchanged' moves no parameter, and 'ema_rate' averages at ten
    times the configured rate (1 − d), as an EMA at 0.999 for 0.9999.

    Returns per step the loss, the batch means (per dimension) of the
    distortion and the rate, each layer's batch-mean KL (nats), the
    gradient's norm and whether the step was skipped; the first step's
    gradients as the optimizer takes them (clipped) by leaf; the
    parameters and the EMA after the last step."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    dev = images.device
    t, m = cfg["train"], cfg["model"]
    net = VDVAE(m, prec or Precision()).to(dev)
    net.load_state_dict(weights)
    names = [n for n, _ in net.named_parameters()]
    params = list(net.parameters())
    ema = [p.detach().clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps_adam = 0.9, t["adam_b2"], 1e-8
    decay = t["ema_decay"]
    if fault == "ema_rate":
        decay = 1.0 - 10.0 * (1.0 - decay)
    applied = start
    dims = math.prod(m["image_shape"])
    out = {"loss": [], "distortion": [], "rate": [], "kl_layers": [],
           "grad_norm": [], "skipped": [], "grad": {}}
    for step in range(start, start + steps):
        gen = stream.step_generator(seed, step)
        idx = torch.from_numpy(batch_rows(images.shape[0], t["batch_size"],
                                          seed, step)).to(dev)
        x = images[idx].to(torch.float32)
        eps = layer_noise(net.layer_shapes(x.shape[0]), gen, dev)
        n = x.shape[0] if rows is None else rows
        x, eps = x[:n], [e[:n] for e in eps]
        x_in, x_t = (x + SHIFT) * SCALE, (x + SHIFT_LOSS) * SCALE_LOSS
        grads = [torch.zeros_like(p) for p in params]
        dist, kls = [], []
        for i in range(0, n, MICRO):
            d, k = net(x_in[i:i + MICRO], x_t[i:i + MICRO],
                       [e[i:i + MICRO] for e in eps],
                       "standard_prior" if fault == "kl_standard_prior"
                       else None)
            rate = (k.detach() if fault == "no_kl_grad" else k).sum(dim=0)
            part = (d + rate).sum() / (n * dims)
            for acc, g in zip(grads, torch.autograd.grad(part, params)):
                acc.add_(g)
            dist.append(d.detach())
            kls.append(k.detach())
        dist, kls = torch.cat(dist), torch.cat(kls, dim=1)
        rate = kls.sum(dim=0)
        norm = float(torch.sqrt(sum(g.double().square().sum()
                                    for g in grads)))
        grads = [g * min(1.0, t["grad_clip_norm"] / (norm + 1e-6))
                 for g in grads]
        skip = not (norm < SKIP_THRESHOLD) or bool(
            torch.isnan(dist.mean()) or torch.isnan(rate.mean()))
        out["loss"].append(float((dist + rate).mean()) / dims)
        out["distortion"].append(float(dist.mean()) / dims)
        out["rate"].append(float(rate.mean()) / dims)
        out["kl_layers"].append(kls.mean(dim=1).tolist())
        out["grad_norm"].append(norm)
        out["skipped"].append(skip)
        if step == start:
            out["grad"] = {nm: float(torch.linalg.vector_norm(g))
                           for nm, g in zip(names, grads)}
        if skip:
            continue
        applied += 1
        lr = lr_at(t, step)
        move = fault != "state_unchanged"
        with torch.no_grad():
            for p, g, m1, m2, e in zip(params, grads, mu, nu, ema):
                if move:
                    p.mul_(1.0 - lr * WEIGHT_DECAY)
                m1.lerp_(g, 1.0 - b1)
                m2.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (m2.sqrt() / math.sqrt(1.0 - b2 ** applied)).add_(
                    eps_adam)
                if move:
                    p.addcdiv_(m1, denom, value=-lr / (1.0 - b1 ** applied))
                e.add_(p - e, alpha=1.0 - decay)
    out["params"] = {nm: p.detach() for nm, p in zip(names, params)}
    out["ema"] = {nm: e for nm, e in zip(names, ema)}
    return out
