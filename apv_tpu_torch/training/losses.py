"""Loss terms (counterpart of ``apv_tpu/training/losses.py``): the
likelihood params and reconstruction term, the ELBO terms, and the
adversarial-prior terms of the G and D phases.

Discriminator convention: ``D(z)`` is the logit that z came from the
aggregate posterior q(z) (class 1) rather than the prior p0(z) (class 0).
At the BCE optimum D(z) = log q(z) − log p0(z), the density ratio the
'learned_prior' variant adds to the ELBO: log p*(z) = log p0(z) + D(z) −
log Z.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from apv_tpu_torch import ops


def decoder_output_to_likelihood_params(out: torch.Tensor, likelihood: str,
                                        image_channels: int):
    """Split the decoder's channel-stacked NHWC output into likelihood
    params, each contiguous, ready for the kernels' [B, H·W·C] rows.

    Bernoulli: out [B,H,W,C] are the logits. Discretized logistic:
    [B,H,W,2C] -> (mean, log_scale), log_scale floored at -7 (PixelCNN++
    convention)."""
    if likelihood == "bernoulli":
        if out.shape[-1] != image_channels:
            raise ValueError(f"decoder output has {out.shape[-1]} channels, "
                             f"expected {image_channels} logits")
        return (out.contiguous(),)
    if likelihood != "discretized_logistic":
        raise NotImplementedError(f"likelihood {likelihood!r} is not ported "
                                  "yet; bernoulli and discretized_logistic "
                                  "are")
    if out.shape[-1] != 2 * image_channels:
        raise ValueError(f"decoder output has {out.shape[-1]} channels, "
                         f"expected {2 * image_channels}")
    mean, log_scale = out.split(image_channels, dim=-1)
    return mean.contiguous(), torch.clamp_min(log_scale, -7.0).contiguous()


def recon_log_likelihood(x_target: torch.Tensor, out: torch.Tensor,
                         likelihood: str, *, samples: int = 1) -> torch.Tensor:
    """Per-sample reconstruction log-likelihood [B] via the ops; with
    ``samples=S``, ``out`` holds S decodings of each of x_target's B images
    ([S·B, ...], sample-major) and the result has S·B rows."""
    params = decoder_output_to_likelihood_params(out, likelihood,
                                                 x_target.shape[-1])
    if likelihood == "bernoulli":
        return ops.bernoulli_recon_ll(x_target, params[0], samples=samples)
    return ops.disc_logistic_recon_ll(x_target, *params, samples=samples)


def elbo_terms(encode: Callable, decode: Callable, x_in: torch.Tensor,
               x_target: torch.Tensor, likelihood: str, *,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
    """One forward pass: returns (recon [B], kl [B], z [B, Z]).

    ``eps`` (CPU only) injects the reparameterization noise."""
    mean, logvar = encode(x_in)
    z = ops.reparam_sample(mean, logvar, generator=generator, eps=eps)
    out = decode(z)
    recon = recon_log_likelihood(x_target, out, likelihood)
    kl = ops.kl_standard(mean, logvar)
    return recon, kl, z


def generator_adv_term(d_logits_q: torch.Tensor, variant: str) -> torch.Tensor:
    """Per-sample latent-space term added to the ELBO (higher is better for
    G): +D(z) for the learned prior, log(1 − σ(D)) for 'aae'."""
    if variant in ("learned_prior", "biadversarial"):
        return d_logits_q
    if variant == "aae":
        return -F.softplus(d_logits_q)
    raise ValueError(f"unknown adversarial variant {variant!r}")


def d_loss_floor(label_smoothing: float) -> float:
    """The analytic minimum of ``discriminator_loss``: 2·H(s) with label
    smoothing s (0 without smoothing); the chance plateau is 2·ln 2."""
    s = float(label_smoothing)
    if s <= 0.0:
        return 0.0
    return -2.0 * (s * math.log(s) + (1.0 - s) * math.log(1.0 - s))


def discriminator_loss(d_logits_q: torch.Tensor, d_logits_p: torch.Tensor,
                       label_smoothing: float = 0.0):
    """BCE, posterior samples -> class 1, prior samples -> class 0, with
    targets (1 − s, s) under label smoothing s. Returns (loss, accuracy)."""
    s = label_smoothing
    loss_q = (1 - s) * F.softplus(-d_logits_q) + s * F.softplus(d_logits_q)
    loss_p = (1 - s) * F.softplus(d_logits_p) + s * F.softplus(-d_logits_p)
    loss = loss_q.mean() + loss_p.mean()
    acc = 0.5 * ((d_logits_q > 0).to(torch.float32).mean()
                 + (d_logits_p <= 0).to(torch.float32).mean())
    return loss, acc
