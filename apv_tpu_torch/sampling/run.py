"""Sampling: SIR and MALA from the shaped prior, the model's trained
priors, ex-post priors, decoding to pixels, image grids (counterpart of
``apv_tpu/sampling/run.py``).

Prior sampling under the adversarial prior uses SIR
(sampling-importance-resampling): draw a pool from the base (N(0, I), or
the trained Gaussian base N(μ, σ)), weight by e^{D(z)}, resample;
``refine_steps > 0`` then runs batched MALA chains on log p*(z) =
log p_base(z) + D(z) from the SIR draws, the step size adapting toward
MALA's optimal acceptance with a Robbins–Monro gain. Gradients of D with
respect to z come from ``torch.autograd.grad``. The trained flow prior is
drawn exactly, by its inverse on a (tempered) base draw. The ex-post
priors are a diagonal Gaussian, a diagonal GMM or a RealNVP flow fitted to
the aggregate posterior.

Every random draw comes from an explicit ``torch.Generator`` on the
sampler's device, and can be injected instead (``pool``, ``pick``,
``noise``, ``uniforms``, ``u``, ``eps``, ``ids``, ``first``): the tests
hand in JAX's own draws. Entry points that take a ``seed`` derive distinct
generators for the latent draw and the pixel noise from it
(``seed_generators``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core import distributions as D
from apv_tpu_torch.core.flow import fit_flow, flow_inverse, flow_logpdf
from apv_tpu_torch.training.losses import decoder_output_to_likelihood_params
from apv_tpu_torch.utils import png

INIT_STEP = 0.1          # MALA's initial step size
TARGET_ACCEPT = 0.574    # MALA's optimal acceptance rate


def seed_generators(seed: int, count: int,
                    device: torch.device | str) -> list[torch.Generator]:
    """``count`` generators on ``device`` with distinct seeds derived from
    ``seed`` (numpy's SeedSequence), so the streams do not overlap."""
    states = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s) >> 1)
            for s in states]


def _check_draw(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"injected {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t


def _normal(shape, generator, device, injected=None, name="normal"):
    if injected is not None:
        return _check_draw(name, injected, shape).to(device, torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def _uniform(shape, generator, device, injected=None, name="uniform"):
    if injected is not None:
        return _check_draw(name, injected, shape).to(device, torch.float32)
    return torch.rand(shape, generator=generator, device=device)


def _categorical(logits: torch.Tensor, n: int, generator,
                 injected=None, name="pick") -> torch.Tensor:
    """n indices drawn with probabilities softmax(logits)."""
    if injected is not None:
        return _check_draw(name, injected, (n,)).to(logits.device,
                                                     torch.int64)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, n, replacement=True, generator=generator)


def shaped_prior_logp(z: torch.Tensor, d: Callable,
                      base_logp: Callable | None = None) -> torch.Tensor:
    """log p*(z) up to the log-partition constant: log p_base(z) + D(z),
    per sample; the base is N(0, I) (up to its constant) unless
    ``base_logp`` gives a trainable base's exact log-density."""
    lp0 = (-0.5 * torch.sum(z * z, dim=-1) if base_logp is None
           else base_logp(z))
    return lp0 + d(z)


def sir_ess(logw: torch.Tensor) -> torch.Tensor:
    """Kish effective sample size (Σw)²/Σw² of log importance weights."""
    return torch.exp(2.0 * torch.logsumexp(logw, dim=0)
                     - torch.logsumexp(2.0 * logw, dim=0))


def langevin_refine(z0: torch.Tensor, logp_fn: Callable, steps: int, *,
                    generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None,
                    uniforms: torch.Tensor | None = None):
    """Batched MALA on an unnormalized log-density ``logp_fn: [n, Z] ->
    [n]``; all n chains step together. The step size starts at
    ``INIT_STEP`` and adapts toward ``TARGET_ACCEPT`` with gain 1/(i + 10)
    at step i = 1..steps.

    ``noise`` [steps, n, Z] (the proposals' N(0, I) draws) and ``uniforms``
    [steps, n] (the accept draws) may be injected.

    Returns (z, mean acceptance rate, final step size), the last two as
    float32 0-d tensors.
    """
    if steps < 1:
        raise ValueError(f"langevin_refine needs steps >= 1, got {steps} "
                         "(a 0-step scan would report a NaN acceptance "
                         "rate; skip the call instead)")
    n = z0.shape[0]
    dev = z0.device

    def logp_and_grad(z):
        z = z.detach().requires_grad_(True)
        lp = logp_fn(z)
        (g,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), g.detach()

    with torch.inference_mode(False), torch.enable_grad():
        z = z0.to(torch.float32).clone()
        lp, g = logp_and_grad(z)
        log_eps = torch.log(torch.tensor(INIT_STEP, dtype=torch.float32,
                                         device=dev))
        rates = []
        for i in range(steps):
            eps = torch.exp(log_eps)
            nz = _normal(z.shape, generator, dev,
                         None if noise is None else noise[i], "noise")
            z_prop = z + eps * g + torch.sqrt(2.0 * eps) * nz
            lp_p, g_p = logp_and_grad(z_prop)
            fwd = -torch.sum((z_prop - z - eps * g) ** 2, -1) / (4.0 * eps)
            rev = -torch.sum((z - z_prop - eps * g_p) ** 2, -1) / (4.0 * eps)
            log_alpha = lp_p - lp + rev - fwd
            u = torch.log(_uniform((n,), generator, dev,
                                   None if uniforms is None else uniforms[i],
                                   "uniforms"))
            accept = u < log_alpha
            z = torch.where(accept[:, None], z_prop, z)
            lp = torch.where(accept, lp_p, lp)
            g = torch.where(accept[:, None], g_p, g)
            rate = accept.to(torch.float32).mean()
            log_eps = log_eps + (rate - TARGET_ACCEPT) / (i + 1 + 10.0)
            rates.append(rate)
    return z.detach(), torch.stack(rates).mean(), torch.exp(log_eps)


def sample_prior(n: int, z_dim: int, *, d: Callable | None = None,
                 pool_factor: int = 16, refine_steps: int = 0,
                 return_diagnostics: bool = False,
                 generator: torch.Generator | None = None, device=None,
                 base_from: Callable | None = None,
                 base_logp: Callable | None = None,
                 pool: torch.Tensor | None = None,
                 pick: torch.Tensor | None = None,
                 mala_noise: torch.Tensor | None = None,
                 mala_uniforms: torch.Tensor | None = None):
    """n draws from the prior: the base without ``d``; with the latent D,
    SIR from the shaped prior over a pool of ``n * pool_factor`` base
    draws, optionally MALA-refined for ``refine_steps``.

    The base is N(0, I) unless ``base_from`` (u ~ N(0, I) -> z) and
    ``base_logp`` (its log-density, MALA's target with D) give a trainable
    one; they come as a pair.

    Draws: ``pool`` (the N(0, I) draws: [n, Z] without D, [n·pool_factor,
    Z] with it), ``pick`` ([n] pool indices), ``mala_noise`` and
    ``mala_uniforms`` (``langevin_refine``'s) may be injected.

    With ``return_diagnostics`` also returns a dict: the SIR pool's
    effective sample size and size and, when refining, the MALA acceptance
    rate, adapted step size and step count.
    """
    if (base_from is None) != (base_logp is None):
        raise ValueError("base_from and base_logp come as a pair (the SIR "
                         "pool and the MALA target must use the same base)")
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    if d is None:
        if refine_steps > 0:
            raise ValueError("refine_steps applies to the adversarially-"
                             "shaped prior; this model has no latent "
                             "discriminator — drop --refine")
        z = _normal((n, z_dim), generator, dev, pool, "pool")
        if base_from is not None:
            z = base_from(z)
        return (z, {}) if return_diagnostics else z
    pool = _normal((n * pool_factor, z_dim), generator, dev, pool, "pool")
    if base_from is not None:
        pool = base_from(pool)
    logw = d(pool)
    idx = _categorical(logw, n, generator, pick)
    z = pool[idx]
    diag = {"sir_ess": sir_ess(logw), "sir_pool": n * pool_factor}
    if refine_steps > 0:
        z, rate, eps = langevin_refine(
            z, lambda zz: shaped_prior_logp(zz, d, base_logp), refine_steps,
            generator=generator, noise=mala_noise, uniforms=mala_uniforms)
        diag.update(mala_accept_rate=rate, mala_step_size=eps,
                    mala_steps=refine_steps)
    return (z, diag) if return_diagnostics else z


def decoder_pixels(out: torch.Tensor, likelihood: str, image_channels: int,
                   mode: str = "mean", *,
                   generator: torch.Generator | None = None,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder output -> images in [0, 1]: the ``mean`` of the pixel
    likelihood, or a ``sample`` from it (Bernoulli: u < p; discretized
    logistic: the logistic draw at u). ``u`` (the uniforms) may be
    injected."""
    if mode not in ("mean", "sample"):
        raise ValueError(f"unknown pixel mode {mode!r} (mean|sample)")
    lik = decoder_output_to_likelihood_params(out, likelihood,
                                              image_channels)
    if likelihood == "bernoulli":
        probs = torch.sigmoid(lik[0].to(torch.float32))
        if mode == "mean":
            return probs
        return (_uniform(probs.shape, generator, probs.device, u, "u")
                < probs).to(torch.float32)
    mean, log_scale = lik
    if mode == "mean":
        return torch.clamp(mean.to(torch.float32), 0.0, 1.0)
    return D.discretized_logistic_sample(mean, log_scale,
                                         generator=generator, u=u)


def expost_prior_moments(model, x_in: torch.Tensor):
    """Aggregate-posterior moments for the ex-post generation prior: a
    diagonal Gaussian fit to q(z) = E_x[q(z|x)] by the law of total
    variance, mean = E_x[μ(x)], var = Var_x(μ(x)) + E_x[σ²(x)].
    Returns ([Z], [Z]) on x_in's device."""
    with torch.no_grad():
        mean, logvar = model.encode(x_in)
        mean, logvar = mean.to(torch.float32), logvar.to(torch.float32)
        agg_mean = mean.mean(dim=0)
        agg_var = (mean.var(dim=0, unbiased=False)
                   + torch.exp(logvar).mean(dim=0))
    return agg_mean, agg_var


VAR_FLOOR = 1e-6         # the GMM's least component variance


def fit_gmm_em(z: torch.Tensor, k: int, *, iters: int = 75,
               generator: torch.Generator | None = None,
               first: int | None = None):
    """Diagonal-covariance GMM fit by EM.

    The E-step's [N, K] log-densities are three matmuls (‖z‖²·(1/v)ᵀ −
    2z·(μ/v)ᵀ + c_k). Means start at farthest points (a random first
    point, then the argmax of the min distance so far), variances at the
    global diagonal variance, weights uniform. ``first`` (the first
    point's index) may be injected.

    Returns (log_weights [K], means [K, Z], variances [K, Z]).
    """
    z = z.to(torch.float32)
    n, dim = z.shape
    if k > n:
        raise ValueError(f"cannot fit k={k} components to {n} points")
    if first is None:
        first = int(torch.randint(0, n, (), generator=generator,
                                  device=z.device))
    picks = [z[first]]
    d2 = torch.sum((z - picks[0]) ** 2, dim=1)
    for _ in range(k - 1):
        nxt = z[torch.argmax(d2)]
        picks.append(nxt)
        d2 = torch.minimum(d2, torch.sum((z - nxt) ** 2, dim=1))
    means = torch.stack(picks)
    variances = (z.var(dim=0, unbiased=False) + 1e-4).expand(k, dim)
    log_w = torch.full((k,), -math.log(float(k)), dtype=torch.float32,
                       device=z.device)
    z_sq = z * z
    for _ in range(iters):
        inv_v = 1.0 / variances
        c = torch.sum(means * means * inv_v
                      + torch.log(2.0 * math.pi * variances), dim=1)
        quad = z_sq @ inv_v.T - 2.0 * (z @ (means * inv_v).T)
        log_r = log_w[None, :] - 0.5 * (quad + c[None, :])
        log_r = log_r - torch.logsumexp(log_r, dim=1, keepdim=True)
        r = torch.exp(log_r)
        nk = torch.sum(r, dim=0) + 1e-6
        means = (r.T @ z) / nk[:, None]
        ex2 = (r.T @ z_sq) / nk[:, None]
        variances = torch.clamp_min(ex2 - means * means, VAR_FLOOR)
        log_w = torch.log(nk / n)
    return log_w, means, variances


def posterior_draws(model, x_in: torch.Tensor, draws_per_x: int = 2, *,
                    generator: torch.Generator | None = None,
                    eps: torch.Tensor | None = None) -> torch.Tensor:
    """[draws_per_x · N, Z] samples of the aggregate posterior q(z), the
    target of the ex-post fits, through the reparam op (its kernel on the
    card). ``eps`` [draws_per_x, N, Z] may be injected on the CPU."""
    with torch.no_grad():
        mean, logvar = model.encode(x_in)
        zs = ops.reparam_sample(mean.to(torch.float32),
                                logvar.to(torch.float32), draws_per_x,
                                generator=generator, eps=eps)
    return zs.reshape(-1, zs.shape[-1])


def expost_prior_gmm(model, x_in: torch.Tensor, *, k: int = 10,
                     iters: int = 75, draws_per_x: int = 2,
                     generator: torch.Generator | None = None,
                     eps: torch.Tensor | None = None,
                     first: int | None = None):
    """K-component ex-post prior: EM-fit a diagonal GMM to samples of the
    aggregate posterior. Returns (log_weights [K], means [K, Z],
    variances [K, Z])."""
    z = posterior_draws(model, x_in, draws_per_x, generator=generator,
                        eps=eps)
    return fit_gmm_em(z, k, iters=iters, generator=generator, first=first)


def expost_prior_flow(model, x_in: torch.Tensor, *, n_layers: int = 6,
                      hidden: int = 64, steps: int = 2000,
                      draws_per_x: int = 4,
                      generator: torch.Generator | None = None,
                      eps: torch.Tensor | None = None, fit_draws=None):
    """Flow ex-post prior: a RealNVP MLE-fit to aggregate-posterior samples
    (``core/flow.fit_flow``). Returns the flow params dict, the third
    ``prior_moments`` form beside the two tuples, with ``flow_nll`` (the
    mean train NLL of the fit's last 50 steps, nats, a 0-d tensor) added.
    ``eps`` [draws_per_x, N, Z] and ``fit_draws`` (``fit_flow``'s ``perm``,
    ``init_draws`` and ``indices``) may be injected."""
    z = posterior_draws(model, x_in, draws_per_x, generator=generator,
                        eps=eps)
    flow, nll_trace = fit_flow(z, n_layers=n_layers, hidden=hidden,
                               steps=steps, generator=generator,
                               **(fit_draws or {}))
    flow["flow_nll"] = nll_trace[-50:].mean()
    return flow


def expost_prior_sample(prior_moments, n: int, z_dim: int, *,
                        generator: torch.Generator | None = None,
                        device=None, eps: torch.Tensor | None = None,
                        ids: torch.Tensor | None = None) -> torch.Tensor:
    """n latents from a fitted ex-post prior: a ``(mean, var)`` diagonal
    Gaussian, a ``(log_w, means, vars)`` diagonal GMM or a flow params
    dict. ``eps`` [n, Z] (the flow's base draw) and ``ids`` [n] (the GMM's
    component picks) may be injected."""
    if isinstance(prior_moments, dict):
        dev = torch.device(device) if device is not None else \
            prior_moments["whiten"]["mean"].device
        return flow_inverse(prior_moments,
                            _normal((n, z_dim), generator, dev, eps, "eps"))
    dev = torch.device(device) if device is not None else \
        prior_moments[0].device
    if len(prior_moments) == 2:
        agg_mean, agg_var = prior_moments
        e = _normal((n, z_dim), generator, dev, eps, "eps")
        return agg_mean + torch.sqrt(agg_var) * e
    log_w, means, variances = prior_moments
    idx = _categorical(log_w, n, generator, ids, "ids")
    e = _normal((n, z_dim), generator, dev, eps, "eps")
    return means[idx] + torch.sqrt(variances[idx]) * e


def expost_prior_logpdf(prior_moments) -> Callable:
    """``z [..., Z] -> log p(z) [...]`` for a fitted ex-post prior, exact
    and closed-form for all three forms."""
    if isinstance(prior_moments, dict):
        return lambda z: flow_logpdf(prior_moments, z)
    if len(prior_moments) == 2:
        agg_mean, agg_var = prior_moments

        def logpdf(z):
            return torch.sum(D.gaussian_logpdf(z, agg_mean,
                                               torch.log(agg_var)), dim=-1)

        return logpdf
    log_w, means, variances = prior_moments
    return lambda z: D.diag_gmm_logpdf(z, log_w, means, variances)


def generate_samples(model, n: int, z_dim: int, likelihood: str,
                     image_channels: int, *, d: Callable | None = None,
                     seed: int = 0, mode: str = "mean",
                     refine_steps: int = 0, prior_moments=None,
                     model_prior: bool = False, model_base: bool = False,
                     temperature: float = 1.0,
                     return_diagnostics: bool = False,
                     draws: dict | None = None):
    """Decode n prior samples -> images [n, H, W, C] in [0, 1] on the
    model's device.

    The latent draw is SIR (+ MALA with ``refine_steps``) from the shaped
    prior when the latent D ``d`` is given, N(0, I) otherwise, or the
    ex-post prior ``prior_moments`` (from ``expost_prior_moments``,
    ``expost_prior_gmm`` or ``expost_prior_flow``). ``model_prior`` draws
    the model's own trained prior exactly: ``prior_sample_from`` on a base
    draw u ~ N(0, T²I) at ``temperature`` T (the flow's inverse pass).
    ``model_base`` keeps the SIR/MALA machinery over the model's trainable
    Gaussian base, tempered to N(μ, T²σ²) for both the pool and the MALA
    target. The latent draw and the pixel noise use distinct generators
    derived from ``seed``. ``draws`` injects draws by name: ``pool`` (the
    N(0, I) base draws, also the trained prior's), ``pick``,
    ``mala_noise``, ``mala_uniforms`` (the shaped prior), ``eps``, ``ids``
    (the ex-post prior) and ``pixel_u``.
    """
    if prior_moments is not None and refine_steps > 0:
        raise ValueError("refine_steps applies to the adversarially-shaped "
                         "prior; the ex-post prior is sampled exactly — "
                         "use one or the other")
    if model_prior and (prior_moments is not None or d is not None
                        or refine_steps > 0):
        raise ValueError("model_prior (the trained flow prior) is drawn "
                         "exactly from the model's params — it excludes "
                         "ex-post moments, a latent D, and refinement")
    if model_base and (model_prior or prior_moments is not None):
        raise ValueError("model_base (shaped prior over the trainable "
                         "gaussian base) excludes model_prior and ex-post "
                         "moments")
    if temperature != 1.0 and not (model_prior or model_base):
        raise ValueError("temperature applies to the model's own trained "
                         "prior (model.prior='flow'/'gaussian' drawn via "
                         "prior_sample_from) - other priors are drawn at "
                         "their fitted scale")
    draws = draws or {}
    dev = next(model.parameters()).device
    gen_z, gen_x = seed_generators(seed, 2, dev)
    with torch.no_grad():
        if prior_moments is not None:
            z = expost_prior_sample(prior_moments, n, z_dim, generator=gen_z,
                                    device=dev, eps=draws.get("eps"),
                                    ids=draws.get("ids"))
            diag = {}
        elif model_prior:
            u = _normal((n, z_dim), gen_z, dev, draws.get("pool"), "pool")
            z = model.prior_sample_from(temperature * u)
            diag = {}
        else:
            base_from = base_logp = None
            if model_base:
                def base_from(u):
                    return model.prior_sample_from(temperature * u)

                def base_logp(zz):
                    if temperature != 1.0:
                        # log N(z; μ, T²σ²) = log N(μ + (z − μ)/T; μ, σ²)
                        # + const; MALA needs only its gradient
                        mu = model.prior_sample_from(torch.zeros_like(zz))
                        zz = mu + (zz - mu) / temperature
                    return model.prior_logpdf(zz)
            z, diag = sample_prior(
                n, z_dim, d=d, refine_steps=refine_steps,
                return_diagnostics=True, generator=gen_z, device=dev,
                base_from=base_from, base_logp=base_logp,
                pool=draws.get("pool"), pick=draws.get("pick"),
                mala_noise=draws.get("mala_noise"),
                mala_uniforms=draws.get("mala_uniforms"))
        out = model.decode(z)
        images = decoder_pixels(out, likelihood, image_channels, mode,
                                generator=gen_x, u=draws.get("pixel_u"))
    if return_diagnostics:
        return images, {k: (float(v) if torch.is_tensor(v) else v)
                        for k, v in diag.items()}
    return images


def reconstruct_images(model, x_in: torch.Tensor, likelihood: str,
                       image_channels: int, *, seed: int = 0,
                       mode: str = "mean", eps: torch.Tensor | None = None,
                       pixel_u: torch.Tensor | None = None) -> torch.Tensor:
    """x -> a q(z|x) sample -> decode -> images in [0, 1]. ``eps`` (CPU)
    and ``pixel_u`` may be injected."""
    gen_z, gen_x = seed_generators(seed, 2, x_in.device)
    with torch.no_grad():
        mean, logvar = model.encode(x_in)
        z = ops.reparam_sample(mean.to(torch.float32),
                               logvar.to(torch.float32), generator=gen_z,
                               eps=eps)
        out = model.decode(z)
        return decoder_pixels(out, likelihood, image_channels, mode,
                              generator=gen_x, u=pixel_u)


def latent_interpolate(model, x_a: torch.Tensor, x_b: torch.Tensor,
                       steps: int, likelihood: str, image_channels: int, *,
                       kind: str = "slerp") -> torch.Tensor:
    """Decode a latent path between two image batches (posterior means;
    ``slerp`` along the great circle or ``lerp``), every step in one
    batched pass. Returns [P, steps, H, W, C] for P pairs."""
    with torch.no_grad():
        z_a = model.encode(x_a)[0].to(torch.float32)
        z_b = model.encode(x_b)[0].to(torch.float32)
        t = torch.linspace(0.0, 1.0, steps, device=z_a.device)[None, :, None]
        za, zb = z_a[:, None, :], z_b[:, None, :]
        if kind == "slerp":
            na = torch.linalg.norm(za, dim=-1, keepdim=True)
            nb = torch.linalg.norm(zb, dim=-1, keepdim=True)
            cos = torch.sum(za * zb, -1, keepdim=True) / (na * nb + 1e-9)
            omega = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
            so = torch.sin(omega)
            z = (torch.sin((1 - t) * omega) / so * za
                 + torch.sin(t * omega) / so * zb)
        elif kind == "lerp":
            z = (1 - t) * za + t * zb
        else:
            raise ValueError(f"unknown interpolation kind {kind!r}")
        p, s, zd = z.shape
        img = decoder_pixels(model.decode(z.reshape(p * s, zd)), likelihood,
                             image_channels, "mean")
    return img.reshape((p, s) + tuple(img.shape[1:]))


def image_grid(images, *, cols: int = 8, pad: int = 2) -> np.ndarray:
    """[N, H, W, C] floats in [0, 1] -> the uint8 grid ``save_image_grid``
    writes: ``cols`` images a row, ``pad`` white pixels between them,
    levels floor(clip(v, 0, 1)·255); [rows, cols] for C = 1."""
    arr = (images.detach().to(torch.float32).cpu().numpy()
           if torch.is_tensor(images) else np.asarray(images, np.float32))
    n, h, w, c = arr.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    grid = np.ones((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = arr[i]
    img = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def save_image_grid(images, path: str | Path, *, cols: int = 8,
                    pad: int = 2) -> Path:
    """[N, H, W, C] floats in [0, 1] -> one PNG grid (``utils/png.py``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png.encode_png(image_grid(images, cols=cols, pad=pad)))
    return path
