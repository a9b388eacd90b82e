"""In-process per-sample ELBO scorer (counterpart of
``apv_tpu/serving.py:116-159``, ``_scorer_fn``).

Exporting the scorer (``torch.export``) and int8 weights come later.
"""

from __future__ import annotations

from typing import Callable

import torch

from apv_tpu_torch.data.preprocess import normalize_center
from apv_tpu_torch.training.losses import elbo_terms
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device


def make_scorer(cfg: Config, model, d=None, log_z: float = 0.0, *,
                device=None) -> Callable:
    """Build ``fn(x, *, generator=None, eps=None) -> ELBO [B]`` (nats).

    ``x`` is images [B,H,W,C] in [0,1] on the scorer's device. The input
    convention mirrors eval: binarized configs feed x straight through;
    continuous configs center the encoder input to [-1,1] while the
    likelihood scores the raw [0,1] levels. Adversarial checkpoints (``d``
    given) score under the learned prior: recon − KL(q‖p0) + D(z) − log Z.
    ``eps`` (CPU only) injects the reparameterization noise.
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
            if use_adv:
                elbo = elbo + d(z) - log_z
            return elbo

    return fn
