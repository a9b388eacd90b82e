"""Model construction from config (counterpart of
``apv_tpu/models/registry.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from apv_tpu_torch.models.common import lecun_normal_init_
from apv_tpu_torch.models.conv_vae import ConvVAE
from apv_tpu_torch.models.flow_prior import FlowPrior
from apv_tpu_torch.models.resnet_vae import ResNetVAE
from apv_tpu_torch.utils.device import resolve_device


def build_model(model_cfg, *, dtype: torch.dtype = torch.bfloat16,
                device=None, seed: int = 0) -> nn.Module:
    """Build the VAE named by ``model_cfg.family`` (``conv`` or ``resnet``)
    with its own prior (``model_cfg.prior``: standard, gaussian or flow),
    float32 params (seeded lecun-normal init; the flow's hidden layers
    He-normal from a second numpy stream of the seed) computing in
    ``dtype``, on ``device`` (``None``: the CUDA card, raising if there is
    none). The prior computes in float32 whatever ``dtype``."""
    dev = resolve_device(device)
    if model_cfg.family not in ("conv", "resnet"):
        raise ValueError(f"unknown model family {model_cfg.family!r}")
    prior = dict(prior=getattr(model_cfg, "prior", "standard"),
                 prior_flow_layers=getattr(model_cfg, "prior_flow_layers", 6),
                 prior_flow_hidden=getattr(model_cfg, "prior_flow_hidden",
                                           64))
    if model_cfg.family == "conv":
        model = ConvVAE(z_dim=model_cfg.z_dim, widths=tuple(model_cfg.widths),
                        dense=model_cfg.dense,
                        image_shape=tuple(model_cfg.image_shape), dtype=dtype,
                        likelihood=model_cfg.likelihood,
                        activation=model_cfg.activation,
                        mix_components=model_cfg.mix_components, **prior)
    else:
        model = ResNetVAE(z_dim=model_cfg.z_dim,
                          widths=tuple(model_cfg.widths),
                          blocks_per_stage=model_cfg.blocks_per_stage,
                          image_shape=tuple(model_cfg.image_shape),
                          dtype=dtype, likelihood=model_cfg.likelihood,
                          upsample=model_cfg.upsample,
                          activation=model_cfg.activation,
                          norm=model_cfg.norm,
                          mix_components=model_cfg.mix_components, **prior)
    lecun_normal_init_(model, seed)
    if isinstance(model.prior, FlowPrior):
        model.prior.reset_parameters(np.random.default_rng([seed, 1]))
    return model.to(device=dev, memory_format=torch.channels_last)
