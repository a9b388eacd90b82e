"""Model construction from config (counterpart of
``apv_tpu/models/registry.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from apv_tpu_torch.models.common import lecun_normal_init_
from apv_tpu_torch.models.conv_vae import ConvVAE
from apv_tpu_torch.models.resnet_vae import ResNetVAE
from apv_tpu_torch.utils.device import resolve_device


def build_model(model_cfg, *, dtype: torch.dtype = torch.bfloat16,
                device=None, seed: int = 0) -> nn.Module:
    """Build the VAE named by ``model_cfg.family`` (``conv`` or ``resnet``)
    with float32 params (seeded lecun-normal init) computing in ``dtype``,
    on ``device`` (``None``: the CUDA card, raising if there is none)."""
    dev = resolve_device(device)
    if model_cfg.family not in ("conv", "resnet"):
        raise ValueError(f"unknown model family {model_cfg.family!r}")
    prior = getattr(model_cfg, "prior", "standard")
    if prior != "standard":
        raise NotImplementedError(f"model.prior={prior!r} is not ported yet; "
                                  "only the standard prior is")
    if model_cfg.family == "conv":
        model = ConvVAE(z_dim=model_cfg.z_dim, widths=tuple(model_cfg.widths),
                        dense=model_cfg.dense,
                        image_shape=tuple(model_cfg.image_shape), dtype=dtype,
                        likelihood=model_cfg.likelihood,
                        activation=model_cfg.activation,
                        mix_components=model_cfg.mix_components)
    else:
        model = ResNetVAE(z_dim=model_cfg.z_dim,
                          widths=tuple(model_cfg.widths),
                          blocks_per_stage=model_cfg.blocks_per_stage,
                          image_shape=tuple(model_cfg.image_shape),
                          dtype=dtype, likelihood=model_cfg.likelihood,
                          upsample=model_cfg.upsample,
                          activation=model_cfg.activation,
                          norm=model_cfg.norm,
                          mix_components=model_cfg.mix_components)
    lecun_normal_init_(model, seed)
    return model.to(device=dev, memory_format=torch.channels_last)
