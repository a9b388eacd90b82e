"""Loss terms (counterpart of ``apv_tpu/training/losses.py``): the
likelihood params, reconstruction term and pixel mean, the ELBO terms,
the adversarial terms of the G and D phases (latent, pixel and the R1
penalty), the free-bits KL floors and the IWAE-k training objective.

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
from apv_tpu_torch.core import distributions as D


def decoder_output_to_likelihood_params(out: torch.Tensor, likelihood: str,
                                        image_channels: int):
    """Split the decoder's channel-stacked NHWC output into likelihood
    params.

    Bernoulli: out [B,H,W,C] are the logits. Discretized logistic:
    [B,H,W,2C] -> (mean, log_scale), each contiguous for the kernels'
    [B, H·W·C] rows, log_scale floored at -7 (PixelCNN++ convention).
    Mixture ('disc_logistic_mix'): [B,H,W,3·K·C] -> [B,H,W,C,3K], split on
    the last axis into (means, log_scales floored at -7, mix logits), each
    [B,H,W,C,K], the reference's layout (flax weights convert to it); K is
    read off the channel count."""
    if likelihood == "bernoulli":
        if out.shape[-1] != image_channels:
            raise ValueError(f"decoder output has {out.shape[-1]} channels, "
                             f"expected {image_channels} logits")
        return (out.contiguous(),)
    if likelihood == "disc_logistic_mix":
        k3 = out.shape[-1] // image_channels
        if out.shape[-1] != image_channels * k3 or k3 % 3 != 0:
            raise ValueError(f"disc_logistic_mix head must be 3·K·C "
                             f"channels; got {out.shape[-1]} for "
                             f"C={image_channels}")
        p = out.reshape(tuple(out.shape[:-1]) + (image_channels, k3))
        means, log_scales, logits = p.split(k3 // 3, dim=-1)
        return means, torch.clamp_min(log_scales, -7.0), logits
    if likelihood != "discretized_logistic":
        raise ValueError(f"unknown likelihood {likelihood!r}")
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
    if likelihood == "disc_logistic_mix":
        return ops.disc_logistic_mix_recon_ll(x_target, *params,
                                              samples=samples)
    return ops.disc_logistic_recon_ll(x_target, *params, samples=samples)


def likelihood_pixel_mean(out: torch.Tensor, likelihood: str,
                          image_channels: int) -> torch.Tensor:
    """The likelihood's mean image in [0, 1], differentiable: σ(logits)
    for the Bernoulli, the mean clipped to [0, 1] for the discretized
    logistic, the mixture mean clipped to [0, 1] for the mixture. The x̂
    the biadversarial pixel D judges; the generator's pixel-space gradient
    reaches the decoder through it."""
    params = decoder_output_to_likelihood_params(out, likelihood,
                                                 image_channels)
    if likelihood == "bernoulli":
        return torch.sigmoid(params[0])
    if likelihood == "disc_logistic_mix":
        return torch.clamp(D.discretized_logistic_mixture_mean(
            params[0], params[2]), 0.0, 1.0)
    return torch.clamp(params[0], 0.0, 1.0)


def elbo_terms(encode: Callable, decode: Callable, x_in: torch.Tensor,
               x_target: torch.Tensor, likelihood: str, *,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
    """One forward pass: returns (recon [B], kl [B], z [B, Z]).

    ``eps`` (CPU only) injects the reparameterization noise."""
    mean, logvar = encode(x_in)
    z, kl = ops.reparam_kl(mean, logvar, generator=generator, eps=eps)
    recon = recon_log_likelihood(x_target, decode(z), likelihood)
    return recon, kl, z


def generator_adv_term(d_logits_q: torch.Tensor, variant: str) -> torch.Tensor:
    """Per-sample latent-space term added to the ELBO (higher is better for
    G): +D(z) for the learned prior, log(1 − σ(D)) for 'aae'."""
    if variant in ("learned_prior", "biadversarial"):
        return d_logits_q
    if variant == "aae":
        return -F.softplus(d_logits_q)
    raise ValueError(f"unknown adversarial variant {variant!r}")


def pixel_g_term(dx_logits: torch.Tensor) -> torch.Tensor:
    """Per-sample pixel-space generator term (biadversarial, higher is
    better for G): the non-saturating log σ(D_x(x̂))."""
    return -F.softplus(-dx_logits)


def r1_penalty(d_fn: Callable, x_real: torch.Tensor) -> torch.Tensor:
    """R1 penalty ½·E[‖∇_x D(x)‖²] on real samples (Mescheder et al. 2018,
    eq. 9), x [B, Z] or [B, H, W, C], the norm over all non-batch axes.
    The input gradient is taken with ``create_graph=True``, so the penalty
    is differentiable in D's parameters (a second backward through D).
    ∇_x Σ_b D(x_b) is the stack of per-sample gradients: neither D couples
    samples across the batch."""
    x = x_real.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    sq = g.reshape(g.shape[0], -1).to(torch.float32).square().sum(dim=-1)
    return 0.5 * sq.mean()


def loss_scale(cfg) -> float:
    """The factor of a summed loss under ``train.loss_reduction``: 1/(H·W·C)
    under 'mean_per_dim', 1 under 'sum'."""
    reduction = cfg.train.loss_reduction
    if reduction == "mean_per_dim":
        return 1.0 / float(math.prod(cfg.model.image_shape))
    if reduction == "sum":
        return 1.0
    raise ValueError(f"unknown loss_reduction {reduction!r} "
                     "(sum|mean_per_dim)")


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


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def free_bits_kl(mean: torch.Tensor, logvar: torch.Tensor,
                 free_bits: float, batch_mean: Callable = _identity
                 ) -> torch.Tensor:
    """Free-bits KL objective (Kingma et al., IAF appendix C.8): the
    batch-mean per-dimension KL floored at ``free_bits`` nats before the
    sum, Σ_j max(λ, E_B[KL_j]). A scalar; the reported metrics keep the
    true KL. ``batch_mean`` maps this batch's means to the global batch's
    (the data-parallel step's group mean)."""
    kd = batch_mean(D.gaussian_kl_standard(mean, logvar).mean(dim=0))
    return torch.sum(torch.clamp_min(kd, free_bits))


def free_bits_kl_gaussian_base(mean: torch.Tensor, logvar: torch.Tensor,
                               mu_p: torch.Tensor, logvar_p: torch.Tensor,
                               free_bits: float,
                               batch_mean: Callable = _identity
                               ) -> torch.Tensor:
    """``free_bits_kl`` against the trainable Gaussian base N(μ_p, σ_p²):
    its analytic KL splits per dimension, so the floor is exact. A floored
    dimension passes no gradient to the encoder nor to the base."""
    kd = batch_mean(D.gaussian_kl(mean, logvar, mu_p, logvar_p).mean(dim=0))
    return torch.sum(torch.clamp_min(kd, free_bits))


def free_information_kl(kl_mc: torch.Tensor, z_dim: int,
                        free_bits: float, batch_mean: Callable = _identity
                        ) -> torch.Tensor:
    """Total-KL floor for the flow prior, whose MC KL log q − log p_θ does
    not split per dimension: max(E_B[KL], z_dim·λ) ("free information")."""
    return torch.clamp_min(batch_mean(kl_mc.mean()), z_dim * free_bits)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by
    ``holder["w"]`` (broadcast over the trailing axes), which the caller
    sets after the forward."""

    @staticmethod
    def forward(ctx, x, holder):
        ctx.holder = holder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        w = ctx.holder["w"]
        return g * w.reshape(w.shape + (1,) * (g.dim() - w.dim())), None


def iwae_objective(model, x_in: torch.Tensor, x_target: torch.Tensor,
                   likelihood: str, k: int, beta: float,
                   grad_estimator: str = "dreg", *,
                   trained_prior: bool = False,
                   d: Callable | None = None,
                   adv_variant: str | None = None,
                   adv_weight: float = 0.0,
                   px: Callable | None = None, px_weight: float = 0.0,
                   generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None):
    """IWAE-k training objective (arXiv 1509.00519), the bound the k=1000
    evaluator estimates, with small k:

        L_k = E_B[logsumexp_i(log w_i) − log k],
        log w_i = recon(z_i) + β·(log p(z_i) − log q(z_i|x)).

    The k samples fold into the decoder's batch: ``ops.reparam_sample``
    draws z [k, B, Z] (its backward sums over the k samples), the decoder
    runs once on [k·B] rows and the likelihood op scores them against
    x_target's B rows (``samples=k``), which it never copies.

    ``trained_prior`` takes log p from ``model.prior_logpdf`` (the flow or
    Gaussian base) instead of N(0, I); its parameters are θ-side. ``d``
    (the latent D, a constant here): 'learned_prior' puts β·w·D(z_i)
    inside log w_i, 'aae' adds w·mean(−softplus(D)) outside the bound.
    ``px`` (the biadversarial pixel D, a constant here) adds
    ``px_weight``·mean(log σ(D_x(x̂))) over the k decoded means outside the
    bound; under DReG on a second decode of z detached, so its gradient
    reaches the decoder and not the encoder. aux then holds ``g_px`` and
    ``x_hat``, the first sample's x̂ [B, ...], detached, for D's reuse.

    ``grad_estimator``: 'reparam' differentiates the bound; 'dreg'
    (Tucker et al. 2018) gives the same value with the
    doubly-reparameterized gradient: φ reaches log w only through z, with
    q's (μ, log σ²) and the prior's parameters detached, weighted by w̃²;
    θ (decoder and prior) reaches it with z detached, weighted by w̃. One
    decoder pass serves both: the decoder's input rows carry a gradient
    hook that multiplies the w̃-weighted z-gradient by w̃ once more.

    ``eps`` [k, B, Z] (CPU only) injects the reparameterization noise.
    Returns ``(objective, aux, z_q)``: the scalar objective (higher is
    better), the metric dict and sample 0 [B, Z], detached, for D's reuse.
    """
    if grad_estimator not in ("reparam", "dreg"):
        raise ValueError(f"unknown iwae grad estimator {grad_estimator!r} "
                         "(reparam|dreg)")
    dreg = grad_estimator == "dreg"
    mean, logvar = model.encode(x_in)
    b = x_in.shape[0]
    z = ops.reparam_sample(mean, logvar, k, generator=generator, eps=eps)
    holder: dict = {}
    z_dec = _ScaleGrad.apply(z, holder) if dreg else z
    out = model.decode(z_dec.reshape(k * b, -1))
    recon = recon_log_likelihood(x_target, out, likelihood,
                                 samples=k).reshape(k, b)

    def log_p(detach_params: bool) -> torch.Tensor:
        if trained_prior:
            return model.prior_logpdf(z, detach_params=detach_params)
        return torch.sum(D.standard_gaussian_logpdf(z), dim=-1)

    m_q, lv_q = (mean.detach(), logvar.detach()) if dreg else (mean, logvar)
    log_p0 = log_p(detach_params=dreg)
    log_q = torch.sum(D.gaussian_logpdf(z, m_q, lv_q), dim=-1)
    d_logits = None
    if d is not None:
        d_logits = d(z.reshape(k * b, -1)).reshape(k, b)
    prior_term = beta * (log_p0 - log_q)
    if d is not None and adv_variant in ("learned_prior", "biadversarial"):
        # D(z) is part of log p*(z): it rides β like the KL
        prior_term = prior_term + beta * adv_weight * d_logits
    log_w = recon + prior_term
    bound = torch.mean(torch.logsumexp(log_w, dim=0) - math.log(float(k)))
    if dreg:
        w_tilde = torch.softmax(log_w.detach(), dim=0)           # [k, B]
        holder["w"] = w_tilde
        # recon enters at w̃ (θ's weight); the hook lifts its z-path to w̃²
        theta_path = recon
        if trained_prior:
            theta_path = theta_path + beta * model.prior_logpdf(z.detach())
        surrogate = torch.mean(torch.sum(
            w_tilde * theta_path + w_tilde.square() * prior_term, dim=0))
        objective = bound.detach() + surrogate - surrogate.detach()
    else:
        objective = bound
    with torch.no_grad():
        log_q_true = torch.sum(D.gaussian_logpdf(z, mean, logvar), dim=-1)
        aux = {"iwae_bound": bound.detach(), "recon": recon.mean(),
               "kl": (log_q_true - log_p0).mean()}
    if d is not None:
        adv_term = generator_adv_term(d_logits, adv_variant)
        aux["g_adv"] = adv_term.detach().mean()
        if adv_variant == "aae":
            objective = objective + adv_weight * adv_term.mean()
    if px is not None and px_weight > 0.0:
        out_px = model.decode(z.detach().reshape(k * b, -1)) if dreg else out
        x_hat = likelihood_pixel_mean(out_px, likelihood, x_target.shape[-1])
        px_term = pixel_g_term(px(x_hat))
        aux["g_px"] = px_term.detach().mean()
        aux["x_hat"] = x_hat.detach().reshape(k, b, *x_hat.shape[1:])[0]
        objective = objective + px_weight * px_term.mean()
    return objective, aux, z[0].detach()

