"""Distributions and likelihoods in plain PyTorch (counterpart of
``apv_tpu/core/distributions.py``).

All functions are elementwise over arbitrary batch shapes and compute in
float32 whatever the input dtype; reductions over event dims are the
caller's job (the kernels in ``apv_tpu_torch.ops`` do reduce).

The discretized logistic uses the exact log-space CDF-difference identity
    log(sigma(a) - sigma(b)) = b + log(expm1(a - b)) - softplus(a) - softplus(b)
with log(expm1(t)) evaluated on two branches, and edge bins that integrate
the full left/right tail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + e^v) as max(v, 0) + log1p(e^{-|v|}), as jax.nn.softplus."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def gaussian_logpdf(z: torch.Tensor, mean: torch.Tensor,
                    logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(z; mean, exp(logvar))."""
    z, mean, logvar = _f32(z), _f32(mean), _f32(logvar)
    return -0.5 * (_LOG_2PI + logvar + (z - mean) ** 2 * torch.exp(-logvar))


def standard_gaussian_logpdf(z: torch.Tensor) -> torch.Tensor:
    """Elementwise log N(z; 0, I)."""
    z = _f32(z)
    return -0.5 * (_LOG_2PI + z * z)


def gaussian_kl_standard(mean: torch.Tensor,
                         logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(mean, exp(logvar)) || N(0, 1) )."""
    mean, logvar = _f32(mean), _f32(logvar)
    return 0.5 * (mean * mean + torch.exp(logvar) - 1.0 - logvar)


def gaussian_kl(mean_q: torch.Tensor, logvar_q: torch.Tensor,
                mean_p: torch.Tensor, logvar_p: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(mean_q, exp(logvar_q)) || N(mean_p, exp(logvar_p)) )."""
    mean_q, logvar_q, mean_p, logvar_p = (
        _f32(a) for a in (mean_q, logvar_q, mean_p, logvar_p))
    var_ratio = torch.exp(logvar_q - logvar_p)
    t = (mean_q - mean_p) ** 2 * torch.exp(-logvar_p)
    return 0.5 * (var_ratio + t - 1.0 - (logvar_q - logvar_p))


def bernoulli_logpmf(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Elementwise log Bernoulli(x; sigmoid(logits)) = x·l − softplus(l).

    The softplus is PyTorch's, whose autograd derivative is sigmoid(l)
    everywhere (the max/abs form above has a kink at l = 0 under autograd),
    so CPU training differentiates to the same rule as ``_bernoulli_bwd``.
    """
    x, logits = _f32(x), _f32(logits)
    return x * logits - F.softplus(logits)


def discretized_logistic_logpmf(x: torch.Tensor, mean: torch.Tensor,
                                log_scale: torch.Tensor, *,
                                bin_size: float = 1.0 / 255.0,
                                low: float = 0.0,
                                high: float = 1.0) -> torch.Tensor:
    """Elementwise log P(pixel bin) under a discretized logistic.

    ``x`` holds bin centers in [low, high] on a grid of spacing
    ``bin_size``. Interior bins use the exact log CDF difference; the
    lowest bin integrates the left tail, the highest the right tail.
    """
    x, mean, log_scale = _f32(x), _f32(mean), _f32(log_scale)
    inv_s = torch.exp(-log_scale)
    half = 0.5 * bin_size
    a = (x - mean + half) * inv_s          # upper bin edge, standardized
    b = (x - mean - half) * inv_s          # lower bin edge, standardized
    t = bin_size * inv_s                   # a - b, exactly positive

    log_cdf_low = -softplus(-a)
    log_sf_high = -softplus(b)
    # log(expm1(t)): t + log1p(-e^{-t}) for large t, log(t) + log1p(t/2)
    # as t -> 0; each branch clamps its own input so the unselected branch
    # stays finite.
    t_big = torch.clamp_min(t, 1e-3)
    t_small = torch.clamp(t, 1e-20, 1e-3)
    log_expm1_t = torch.where(
        t > 1e-3,
        t_big + torch.log1p(-torch.exp(-t_big)),
        torch.log(t_small) + torch.log1p(0.5 * t_small))
    log_interior = b + log_expm1_t - softplus(a) - softplus(b)

    is_low = x <= low + half
    is_high = x >= high - half
    return torch.where(is_low, log_cdf_low,
                       torch.where(is_high, log_sf_high, log_interior))


def discretized_logistic_sample(mean: torch.Tensor, log_scale: torch.Tensor,
                                *, generator: torch.Generator | None = None,
                                u: torch.Tensor | None = None,
                                bin_size: float = 1.0 / 255.0,
                                low: float = 0.0,
                                high: float = 1.0) -> torch.Tensor:
    """Sample a pixel: logistic noise + mean, quantized to the bin grid.

    u ~ U[1e-5, 1 − 1e-5) of the broadcast shape comes from ``generator``
    (on mean's device), or is injected as ``u``."""
    mean, log_scale = _f32(mean), _f32(log_scale)
    shape = torch.broadcast_shapes(mean.shape, log_scale.shape)
    if u is None:
        u = torch.rand(shape, generator=generator, device=mean.device) \
            * (1.0 - 2e-5) + 1e-5
    elif tuple(u.shape) != tuple(shape):
        raise ValueError(f"discretized_logistic_sample: u has shape "
                         f"{tuple(u.shape)}, expected {tuple(shape)}")
    y = mean + torch.exp(log_scale) * (torch.log(u) - torch.log1p(-u))
    y = torch.round(y / bin_size) * bin_size
    return torch.clamp(y, low, high)


def diag_gmm_logpdf(z: torch.Tensor, log_w: torch.Tensor, means: torch.Tensor,
                    variances: torch.Tensor) -> torch.Tensor:
    """log density of a diagonal-covariance Gaussian mixture over the last
    axis: ``z [..., Z]``, ``log_w [K]``, ``means/variances [K, Z]`` ->
    ``[...]``, an exact logsumexp over the K component log-densities."""
    z = _f32(z)[..., None, :]                                 # [..., 1, Z]
    comp = -0.5 * torch.sum((z - means) ** 2 / variances + _LOG_2PI
                            + torch.log(variances), dim=-1)
    return torch.logsumexp(log_w + comp, dim=-1)
