"""The vdvae family's train step (``model.family='vdvae'``, the port's
own), behind the step's skeleton (``training/step.py``).

The family has no single encode -> z -> decode: its step feeds the uint8
levels at VDVAE's scaling (``models/vdvae.prepare``), runs the model's
encoder, top-down pass and mixture head, each layer drawing its z and KL
from its own key of the step's generator (``ops.reparam_prior_kl``) in
layer order, and takes the loss distortion + Σ_layers KL (per dimension
under ``mean_per_dim``). Its optimizer is VDVAE's skipping AdamW
(``optim.SkippingAdamW``), whose skip is decided on the device; a record
carries the cumulative count of skipped updates (``skipped_updates``) and
the batch mean of each layer's KL (``kl_layers``).
"""

from __future__ import annotations

import math

import torch

from apv_tpu_torch.models.vdvae import prepare
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.training.losses import loss_scale
from apv_tpu_torch.training.optim import SkippingAdamW, warmup_constant
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.logging import span


class VDVAEStep:
    """The vdvae family's step (module docstring)."""

    def __init__(self, cfg: Config):
        t = cfg.train
        if (cfg.adversarial.enabled or t.objective != "elbo"
                or cfg.model.prior != "standard" or t.free_bits > 0.0
                or cfg.data.dequantize or cfg.data.binarize
                or t.grad_accum > 1):
            raise ValueError("the vdvae family trains its own ELBO on uint8 "
                             "levels with its skipping AdamW: no adversarial "
                             "D, objective 'elbo', its learned priors only "
                             "(model.prior 'standard'), no free bits, no "
                             "dequantization or binarization, no gradient "
                             "accumulation")
        self.cfg = cfg
        self.scale = loss_scale(cfg)
        self.dims = float(math.prod(cfg.model.image_shape))

    def init(self, model, seed: int, dtype: torch.dtype, dev) -> tuple:
        """VDVAE's skipping AdamW on its linear warmup to a constant rate;
        no D."""
        t = self.cfg.train
        lr = warmup_constant(t.lr, max(1, t.lr_warmup_steps))
        return SkippingAdamW(model.parameters(), lr, b2=t.adam_b2,
                             clip_norm=t.grad_clip_norm), None, None

    def draw(self, state: TrainState, batch: dict, noise: dict,
             gen: torch.Generator) -> tuple[list, list, list]:
        keys = ([] if "eps" in noise
                else [K.draw_key(gen) for _ in range(state.model.layers)])
        return keys, [], []

    def terms(self, model, batch: dict, gen, eps):
        """The model's pass -> (loss, distortion and rate per image, the
        layers' KLs [L, B]), in nats; ``gen`` gives the layers' keys."""
        distortion, kls = model(*prepare(batch["image"]), generator=gen,
                                eps=eps)
        kls = torch.stack(kls)
        rate = kls.sum(dim=0)
        return (distortion + rate).mean() * self.scale, distortion, rate, kls

    def step(self, state: TrainState, batch: dict, inputs: dict,
             keys: K.StepKeys) -> dict:
        with span("step.g_phase", marks="start"):
            loss, distortion, rate, kls = self.terms(
                state.model, batch, keys, inputs.get("eps"))
            grads = torch.autograd.grad(loss, state.opt.params)
            multihost.average_(list(grads))
            with span("step.g_opt"):
                grad_norm = state.opt.step(
                    grads, (distortion.mean(), rate.mean()),
                    hyper=inputs["hyper"])
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "distortion": distortion.detach().mean() / self.dims,
                "rate": rate.detach().mean() / self.dims,
                "elbo": -(distortion + rate).detach().mean(),
                "kl_layers": kls.detach().mean(dim=1),
                "skipped_updates": state.opt.skipped.clone()}

    def eval_step(self, state: TrainState, batch: dict,
                  gen: torch.Generator, draw_u) -> dict:
        with torch.no_grad():
            _, distortion, rate, _ = self.terms(state.model, batch, gen,
                                                None)
        return {"valid_elbo": -(distortion + rate).mean(),
                "valid_recon": -distortion.mean(), "valid_kl": rate.mean()}
