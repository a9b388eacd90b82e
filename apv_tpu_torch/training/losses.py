"""Forward loss terms of the scoring path (counterpart of
``apv_tpu/training/losses.py:32-71,97-106``).

Only the discretized-logistic likelihood is on this path; the training
objectives and their gradients come with the port's training slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from apv_tpu_torch import ops


def decoder_output_to_likelihood_params(out: torch.Tensor, likelihood: str,
                                        image_channels: int):
    """Split the decoder's channel-stacked NHWC output into likelihood
    params: [B,H,W,2C] -> (mean, log_scale), log_scale floored at -7
    (PixelCNN++ convention). Both come out contiguous, ready for the
    kernel's [B, H·W·C] rows."""
    if likelihood != "discretized_logistic":
        raise NotImplementedError(f"likelihood {likelihood!r} is not ported "
                                  "yet; only discretized_logistic is")
    if out.shape[-1] != 2 * image_channels:
        raise ValueError(f"decoder output has {out.shape[-1]} channels, "
                         f"expected {2 * image_channels}")
    mean, log_scale = out.split(image_channels, dim=-1)
    return mean.contiguous(), torch.clamp_min(log_scale, -7.0).contiguous()


def recon_log_likelihood(x_target: torch.Tensor, out: torch.Tensor,
                         likelihood: str) -> torch.Tensor:
    """Per-sample reconstruction log-likelihood [B] via the ops."""
    mean, log_scale = decoder_output_to_likelihood_params(
        out, likelihood, x_target.shape[-1])
    return ops.disc_logistic_recon_ll(x_target, mean, log_scale)


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
