"""Densities of the reference, in plain float32 torch.

The discretized logistic scores bin centres x = i/255 under (mean, s =
e^log_scale), log_scale floored at -7: interior bins log(σ(a) − σ(b)) with
a, b the bin's edges standardized, written b + log(expm1(a − b)) −
softplus(a) − softplus(b); the lowest bin the left tail log σ(a), the
highest the right tail log σ(−b).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logpdf(z, mean, logvar):
    return -0.5 * (_LOG_2PI + logvar + (z - mean) ** 2 * torch.exp(-logvar))


def standard_logpdf(z):
    return -0.5 * (_LOG_2PI + z * z)


def kl_standard(mean, logvar):
    """Per-row KL(N(mean, e^logvar) || N(0, I)) -> [rows]."""
    return (0.5 * (mean * mean + torch.exp(logvar) - 1.0 - logvar)).sum(-1)


def disc_logistic_ll(x: torch.Tensor, out: torch.Tensor,
                     bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Per-row log-likelihood of bin centres x [R, H, W, C] under the
    decoder output out [R, H, W, 2C] (mean, then log_scale)."""
    c = x.shape[-1]
    mean, log_scale = out[..., :c], torch.clamp_min(out[..., c:], -7.0)
    inv_s = torch.exp(-log_scale)
    half = 0.5 * bin_size
    a = (x - mean + half) * inv_s
    b = (x - mean - half) * inv_s
    t = bin_size * inv_s
    t_big = torch.clamp_min(t, 1e-3)
    t_small = torch.clamp(t, 1e-20, 1e-3)
    log_expm1 = torch.where(t > 1e-3, t_big + torch.log1p(-torch.exp(-t_big)),
                            torch.log(t_small) + torch.log1p(0.5 * t_small))
    interior = b + log_expm1 - F.softplus(a) - F.softplus(b)
    ll = torch.where(x <= half, -F.softplus(-a),
                     torch.where(x >= 1.0 - half, -F.softplus(b), interior))
    return ll.reshape(ll.shape[0], -1).sum(-1)


def bernoulli_ll(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Per-row log-likelihood of binary x [R, H, W, C] under logits out."""
    ll = x * out - F.softplus(out)
    return ll.reshape(ll.shape[0], -1).sum(-1)


def recon_ll(likelihood: str, x: torch.Tensor, out: torch.Tensor):
    if likelihood == "discretized_logistic":
        return disc_logistic_ll(x, out)
    if likelihood == "bernoulli":
        return bernoulli_ll(x, out)
    raise ValueError(f"the reference has no likelihood {likelihood!r}")
