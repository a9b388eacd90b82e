"""In-process serving functions: the prior sampler and the per-sample ELBO
scorer (counterparts of ``apv_tpu/serving.py:30-113``, ``_sampler_fn``,
and ``:116-159``, ``_scorer_fn``), each under the checkpoint's own prior:
N(0, I), the trained flow or Gaussian base, and the adversarial D.

Exporting them (``torch.export``) and int8 weights come later (ROADMAP
queue A item 14b).
"""

from __future__ import annotations

from typing import Callable

import torch

from apv_tpu_torch.core.distributions import standard_gaussian_logpdf
from apv_tpu_torch.data.preprocess import normalize_center
from apv_tpu_torch.training.losses import elbo_terms
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device


def make_sampler(cfg: Config, model, d=None, refine_steps: int = 0,
                 prior_moments=None, *, temperature: float = 1.0,
                 device=None) -> Callable:
    """Build ``fn(seed: int) -> images [cfg.eval.batch_size, H, W, C]`` in
    [0, 1] (the likelihood's mean).

    The latent draw is the ex-post prior ``prior_moments`` when given,
    else SIR (+ ``refine_steps`` of MALA) from the shaped prior when the
    model is adversarial and ``d`` is given (over the trainable base for
    ``model.prior='gaussian'``), else the model's own prior: the trained
    flow or Gaussian base, or N(0, I). ``temperature`` T tempers a trained
    prior's base draw to N(0, T²I). The latent draw and the pixel noise
    take distinct generators derived from the seed
    (``sampling/run.generate_samples``). Refused as the reference refuses:
    ``temperature`` other than 1 on any other prior, ``refine_steps``
    without a latent D or with an ex-post prior.
    """
    from apv_tpu_torch.sampling.run import generate_samples
    dev = resolve_device(device)
    model = model.to(dev)
    use_adv = cfg.adversarial.enabled and d is not None
    trained_prior = cfg.model.prior in ("flow", "gaussian")
    if temperature != 1.0 and (not trained_prior
                               or prior_moments is not None):
        raise ValueError("temperature applies to the model's own trained "
                         "prior (model.prior='flow'/'gaussian'); this "
                         "artifact would sample a different prior")
    if refine_steps > 0 and (not use_adv or prior_moments is not None):
        raise ValueError("refine_steps applies to the adversarially-shaped "
                         "prior; this artifact would sample "
                         + ("the ex-post prior (drawn exactly)"
                            if prior_moments is not None
                            else "a checkpoint with no latent "
                                 "discriminator")
                         + " — a silently-dropped refinement would "
                         "misreport its sampling protocol")
    d_use = d.to(dev) if use_adv else None
    own = prior_moments is None and trained_prior
    model_base = own and use_adv and cfg.model.prior == "gaussian"
    model_prior = own and not model_base

    def fn(seed: int) -> torch.Tensor:
        return generate_samples(model, cfg.eval.batch_size, cfg.model.z_dim,
                                cfg.model.likelihood,
                                cfg.model.image_shape[2], d=d_use,
                                seed=int(seed), mode="mean",
                                refine_steps=refine_steps,
                                prior_moments=prior_moments,
                                model_prior=model_prior,
                                model_base=model_base,
                                temperature=temperature)

    return fn


def make_scorer(cfg: Config, model, d=None, log_z: float = 0.0, *,
                device=None) -> Callable:
    """Build ``fn(x, *, generator=None, eps=None) -> ELBO [B]`` (nats).

    ``x`` is images [B,H,W,C] in [0,1] on the scorer's device. The input
    convention mirrors eval: binarized configs feed x straight through;
    continuous configs center the encoder input to [-1,1] while the
    likelihood scores the raw [0,1] levels. A trained prior
    (``model.prior``) replaces N(0, I) on the same z: + log p_θ(z) −
    log N(z; 0, I). Adversarial checkpoints (``d`` given) score under the
    learned prior: + D(z) − log Z (``log_z`` estimated under the same
    base). ``eps`` (CPU only) injects the reparameterization noise.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    use_adv = cfg.adversarial.enabled and d is not None
    if use_adv:
        d = d.to(dev)

    def fn(x: torch.Tensor, *, generator: torch.Generator | None = None,
           eps: torch.Tensor | None = None) -> torch.Tensor:
        with torch.inference_mode():
            x_in = x if cfg.data.binarize else normalize_center(x)
            recon, kl, z = elbo_terms(model.encode, model.decode, x_in, x,
                                      cfg.model.likelihood,
                                      generator=generator, eps=eps)
            elbo = recon - kl
            if cfg.model.prior in ("flow", "gaussian"):
                elbo = elbo + model.prior_logpdf(z) - torch.sum(
                    standard_gaussian_logpdf(z), dim=-1)
            if use_adv:
                elbo = elbo + d(z) - log_z
            return elbo

    return fn
