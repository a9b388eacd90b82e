"""IWAE-k evaluation (counterpart of ``apv_tpu/eval/iwae_eval.py``).

Per test batch: one encoder pass, then the k=1000 importance samples stream
through a Python loop in chunks (fresh z from the reparam kernel, a decoder
forward and the disc-logistic kernel per chunk, which reads each test
image once for all the chunk's samples) into a running
streaming-logsumexp state, so peak memory is one chunk of decoder
activations.

The prior term is N(0, I), or the model's own trained prior
(``prior_logpdf_p``: the flow or the Gaussian base). With the adversarial learned prior, log p*(z) =
log p_base(z) + D(z) − log Z; ``estimate_log_partition`` MC-estimates
log Z = log E_{p_base}[e^{D(z)}] under the same base.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core import distributions as D
from apv_tpu_torch.core.iwae import iwae_log_likelihood
from apv_tpu_torch.training.losses import recon_log_likelihood
from apv_tpu_torch.utils.device import resolve_device


def sample_posterior_chunk(mean: torch.Tensor, logvar: torch.Tensor,
                           chunk: int, *,
                           generator: torch.Generator | None = None,
                           eps: torch.Tensor | None = None) -> torch.Tensor:
    """Draw [chunk, B, Z] posterior samples: the reparam kernel reads
    mean and logvar as [B, Z] once for all ``chunk`` samples."""
    return ops.reparam_sample(mean, logvar, chunk, generator=generator,
                              eps=eps)


def make_logw_chunk_fn(decode: Callable, likelihood: str, chunk: int,
                       d_apply: Callable | None = None,
                       prior_logpdf_p: Callable | None = None) -> Callable:
    """One chunk's log importance weights [chunk, B] — the one place the
    estimator's math lives.

    ``prior_logpdf_p`` (``z [..., Z] -> [...]``, the model's trained flow
    or Gaussian base) replaces the N(0, I) prior term. ``d_apply``
    (``z [N, Z] -> [N]``) shapes the prior to p*(z) ∝ p_base(z)·e^{D(z)}
    (pass the log Z estimated under the same base).
    """

    def logw_chunk(mean, logvar, x_target, log_z=0.0, *, generator=None,
                   eps=None):
        b = mean.shape[0]
        z = sample_posterior_chunk(mean, logvar, chunk, generator=generator,
                                   eps=eps)
        zf = z.reshape(chunk * b, -1)
        out = decode(zf)
        # x_target [B, ...] against [chunk·B, ...] parameters: the
        # likelihood op reads row r's image as x_target[r % B], no copy
        recon = recon_log_likelihood(x_target, out, likelihood,
                                     samples=chunk).reshape(chunk, b)
        if prior_logpdf_p is not None:
            logp0 = prior_logpdf_p(z)
        else:
            logp0 = D.standard_gaussian_logpdf(z).sum(dim=-1)
        logq = D.gaussian_logpdf(z, mean, logvar).sum(dim=-1)
        logw = recon + logp0 - logq
        if d_apply is not None:
            logw = logw + d_apply(zf).reshape(chunk, b) - log_z
        return logw

    return logw_chunk


def make_iwae_fn(model, likelihood: str, k: int, chunk: int,
                 d_apply: Callable | None = None,
                 prior_logpdf_p: Callable | None = None) -> Callable:
    """Build ``fn(x_in, x_target, log_z=0.0, *, generator, eps) -> [B]``;
    the priors as ``make_logw_chunk_fn``'s.

    ``eps`` ([k // chunk, chunk, B, Z], CPU only) injects each chunk's noise.
    """
    logw_chunk = make_logw_chunk_fn(model.decode, likelihood, chunk, d_apply,
                                    prior_logpdf_p)

    def iwae_fn(x_in, x_target, log_z=0.0, *, generator=None, eps=None):
        mean, logvar = model.encode(x_in)          # [B, Z], once

        def logw_fn(i):
            return logw_chunk(mean, logvar, x_target, log_z,
                              generator=generator,
                              eps=None if eps is None else eps[i])

        return iwae_log_likelihood(logw_fn, k, chunk, (mean.shape[0],),
                                   mean.device)

    return iwae_fn


def estimate_log_partition(d_apply: Callable, z_dim: int, *, seed: int = 0,
                           n: int = 100_000, batch: int = 5_000,
                           with_se: bool = False, device=None,
                           base_from: Callable | None = None,
                           draws: torch.Tensor | None = None):
    """log Z = log E_{z~base}[e^{D(z)}], a streamed logsumexp over n
    draws u ~ N(0, I) from a generator on ``device`` seeded with ``seed``
    (``draws`` [n // batch, batch, Z] injects them). ``base_from`` (``u ->
    z``) maps them to the shaped prior's base: the identity by default,
    the current μ + σ·u for the trainable Gaussian base.

    ``with_se=True`` also returns a delete-one-chunk jackknife standard
    error over the n/batch chunks, each computed as a logsumexp over the
    remaining chunks (never log(e^total - e^{L_i}), which turns into NaN
    when one chunk dominates).
    """
    if n % batch != 0:
        raise ValueError(f"n={n} must be divisible by batch={batch}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def chunk(i):
        u = (draws[i].to(dev) if draws is not None else
             torch.randn((batch, z_dim), generator=gen, device=dev))
        return torch.logsumexp(d_apply(u if base_from is None
                                       else base_from(u)), dim=0)

    chunk_lse = torch.stack([chunk(i) for i in range(n // batch)])
    log_z = torch.logsumexp(chunk_lse, dim=0) - math.log(float(n))
    if not with_se:
        return log_z
    nb = chunk_lse.shape[0]
    if nb < 2:
        raise ValueError(f"jackknife SE needs >= 2 MC chunks; n={n}, "
                         f"batch={batch} gives {nb} — lower batch or skip "
                         "with_se")
    keep = ~torch.eye(nb, dtype=torch.bool, device=dev)   # leave-one-out
    loo = torch.logsumexp(torch.where(keep, chunk_lse[None, :], -torch.inf),
                          dim=1)
    logz_loo = loo - math.log(float(n - batch))
    se = torch.sqrt((nb - 1) / nb
                    * torch.sum((logz_loo - logz_loo.mean()) ** 2))
    return log_z, se
