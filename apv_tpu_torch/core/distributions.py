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


def categorical(logits: torch.Tensor, n: int | None = None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Indices drawn with probabilities softmax(logits) over the last axis:
    ``n`` of them from 1-D logits [K], or with ``n=None`` one for each row
    of logits [..., K] -> [...]."""
    probs = torch.softmax(_f32(logits), dim=-1)
    if n is not None:
        return torch.multinomial(probs, n, replacement=True,
                                 generator=generator)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


# Mixture of discretized logistics (``model.likelihood=disc_logistic_mix``):
# K components per pixel channel, independent across channels, on the same
# 256-level grid as the single logistic.

def discretized_logistic_mixture_logpmf(
        x: torch.Tensor, means: torch.Tensor, log_scales: torch.Tensor,
        mix_logits: torch.Tensor, *, bin_size: float = 1.0 / 255.0,
        low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """Elementwise log P(pixel bin) under a K-component mixture: ``x``
    [...], the parameters [..., K] (mixture axis last) -> [...],
    logsumexp_k(log_softmax(mix_logits)_k + log P_k(bin)), each log P_k the
    single logistic's. x broadcasts against the parameters' leading axes."""
    comp = discretized_logistic_logpmf(x[..., None], means, log_scales,
                                       bin_size=bin_size, low=low, high=high)
    log_w = torch.log_softmax(_f32(mix_logits), dim=-1)
    return torch.logsumexp(log_w + comp, dim=-1)


def discretized_logistic_mixture_mean(means: torch.Tensor,
                                      mix_logits: torch.Tensor
                                      ) -> torch.Tensor:
    """Mixture mean Σ_k softmax(mix_logits)_k · mean_k over the last axis."""
    w = torch.softmax(_f32(mix_logits), dim=-1)
    return torch.sum(w * _f32(means), dim=-1)


def discretized_logistic_mixture_sample(
        means: torch.Tensor, log_scales: torch.Tensor,
        mix_logits: torch.Tensor, *,
        generator: torch.Generator | None = None,
        pick: torch.Tensor | None = None, u: torch.Tensor | None = None,
        bin_size: float = 1.0 / 255.0, low: float = 0.0,
        high: float = 1.0) -> torch.Tensor:
    """A pixel draw: a component per element (``categorical`` on
    ``generator``), then the logistic draw from it. ``pick`` [...] (the
    components) and ``u`` [...] (``discretized_logistic_sample``'s
    uniforms) may be injected."""
    if pick is None:
        pick = categorical(mix_logits, generator=generator)
    elif tuple(pick.shape) != tuple(mix_logits.shape[:-1]):
        raise ValueError(f"discretized_logistic_mixture_sample: pick has "
                         f"shape {tuple(pick.shape)}, expected "
                         f"{tuple(mix_logits.shape[:-1])}")
    idx = pick.to(device=means.device, dtype=torch.int64)[..., None]
    mean = torch.take_along_dim(means, idx, dim=-1)[..., 0]
    log_scale = torch.take_along_dim(log_scales, idx, dim=-1)[..., 0]
    return discretized_logistic_sample(mean, log_scale, generator=generator,
                                       u=u, bin_size=bin_size, low=low,
                                       high=high)


def diag_gmm_logpdf(z: torch.Tensor, log_w: torch.Tensor, means: torch.Tensor,
                    variances: torch.Tensor) -> torch.Tensor:
    """log density of a diagonal-covariance Gaussian mixture over the last
    axis: ``z [..., Z]``, ``log_w [K]``, ``means/variances [K, Z]`` ->
    ``[...]``, an exact logsumexp over the K component log-densities."""
    z = _f32(z)[..., None, :]                                 # [..., 1, Z]
    comp = -0.5 * torch.sum((z - means) ** 2 / variances + _LOG_2PI
                            + torch.log(variances), dim=-1)
    return torch.logsumexp(log_w + comp, dim=-1)


def pixelcnn_mixture_logpmf(x: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """PixelCNN++'s discretized mixture of logistics over RGB (Salimans et
    al. 2017), as VDVAE scores CIFAR-10: per image, the sum over pixels of
    log p(x) -> [B].

    x [B, H, W, 3] holds the levels scaled to [−1, 1] ((v − 127.5)/127.5);
    l [B, H, W, 10·K] is the head: K mixture logits shared by the three
    channels, then per channel (R, G, B) K means, K log-scales (floored at
    −7) and K coefficients (tanh). The G mean adds c₀·x_R, the B mean
    c₁·x_R + c₂·x_G. Bins are 2/255 wide; the edge bins at ±0.999 take the
    tails, and a bin whose mass is under 1e-5 falls back to its log
    density less log 127.5."""
    x, l = _f32(x), _f32(l)
    b, h, w, c = x.shape
    k = l.shape[-1] // 10
    logit_probs = l[..., :k]
    rest = l[..., k:].reshape(b, h, w, c, 3 * k)
    means = rest[..., :k]
    log_scales = torch.clamp_min(rest[..., k:2 * k], -7.0)
    coeffs = torch.tanh(rest[..., 2 * k:3 * k])
    xk = x.unsqueeze(-1)                                   # [B, H, W, 3, 1]
    m1 = means[..., 0, :]
    m2 = means[..., 1, :] + coeffs[..., 0, :] * xk[..., 0, :]
    m3 = (means[..., 2, :] + coeffs[..., 1, :] * xk[..., 0, :]
          + coeffs[..., 2, :] * xk[..., 1, :])
    centered = xk - torch.stack([m1, m2, m3], dim=3)
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / 255.0)
    min_in = inv_stdv * (centered - 1.0 / 255.0)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    log_probs = torch.where(
        xk < -0.999, log_cdf_plus,
        torch.where(xk > 0.999, log_one_minus_cdf_min,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.clamp_min(cdf_delta, 1e-12)),
                                log_pdf_mid - math.log(127.5))))
    log_probs = log_probs.sum(dim=3) + torch.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1).sum(dim=(1, 2))
