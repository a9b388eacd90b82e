"""The train step: the ELBO or the IWAE-k bound, with the model's own
prior (N(0, I), a trained Gaussian base or a trained flow) and the
adversarial latent prior, G phase then D phase, each with its own clipped
Adam (counterpart of ``apv_tpu/training/step.py``).

The reference jits both phases into one XLA program; here they run eagerly
on the card, with the reparameterized sample, the KL and the Bernoulli and
discretized-logistic likelihoods in hand-written kernels whose backward is
a kernel too (``ops/dispatch.py``). The input stage runs on the batch's
device: bit unpacking for the binarized MNIST configs, uniform
dequantization of uint8 levels for CIFAR. Gradient discipline as in the reference: the G phase
differentiates only the VAE's parameters (D's are constants there, and
``torch.autograd.grad`` leaves their ``.grad`` untouched); the D phase
differentiates only D's, on posterior samples that carry no gradient.

Noise: step ``t`` of a run with seed ``s`` draws everything from a CPU
``torch.Generator`` seeded by (s, t) alone, the counterpart of
``fold_in(rng, step)``: never the global generator, so a step can be
replayed. The draws come in a fixed order: the dequantization u, then the
G phase's ε (k of them a row under the IWAE objective), then the flow
dispersion penalty's base draw u (the reference's ``fold_in(key, 1)``;
drawn only when the penalty is on), then the critic's z_p (the u's and z_p
on the device, from a device generator reseeded from the step's
generator). On CPU tensors ``train_step`` also takes the noise injected
(``noise=``), which the parity tests use to hand the port JAX's draws.

The model's prior: the flow takes the single-sample MC KL log q(z|x) −
log p_θ(z), the Gaussian base the analytic KL against (μ, 2·log σ), the
standard prior the KL kernel. The prior's parameters are part of
``model.parameters()``, so the G optimizer clips and updates them with the
VAE's, as optax does with one param tree. With the Gaussian base the D
phase draws z_p from the (detached) base.

Knobs outside this slice raise ``NotImplementedError`` naming the knob;
the combinations the reference refuses raise ``ValueError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core import distributions as D
from apv_tpu_torch.data.preprocess import (normalize_center,
                                           uniform_dequantize, unpack_bits)
from apv_tpu_torch.models import build_model, make_latent_d
from apv_tpu_torch.training import losses as L
from apv_tpu_torch.training.optim import (ClippedAdam, constant,
                                          warmup_cosine_decay)
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device


class TrainFns(NamedTuple):
    init_fn: Callable[[int], TrainState]
    # (state, batch, *, noise=None) -> (state, metrics); updates in place
    train_step: Callable[..., tuple[TrainState, dict]]
    eval_step: Callable[[TrainState, dict], dict]
    device: torch.device


def _make_optimizer(cfg: Config, params) -> ClippedAdam:
    """Clip-by-global-norm then Adam on a warmup-cosine schedule from 0:
    the first update has lr 0. Warmup stays under half the run, so short
    runs still get a valid schedule; decay_steps includes the warmup."""
    t = cfg.train
    updates_total = max(1, t.steps // t.grad_accum)
    warmup = max(1, min(t.lr_warmup_steps // t.grad_accum,
                        updates_total // 2))
    lr = warmup_cosine_decay(0.0, t.lr, warmup,
                             max(updates_total, warmup + 1), t.lr_end_value)
    return ClippedAdam(params, lr, clip_norm=t.grad_clip_norm)


def _make_d_optimizer(cfg: Config, params) -> ClippedAdam:
    """D's Adam: constant d_lr, b1 = 0.5 (GAN convention), own clip."""
    return ClippedAdam(params, constant(cfg.adversarial.d_lr),
                       clip_norm=cfg.train.grad_clip_norm, b1=0.5)


def prepare_batch(cfg: Config, batch: dict, draw_u: Callable | None = None,
                  u: torch.Tensor | None = None):
    """The in-step input stage on the batch's device -> (x_in, x_target).

    * ``image_packed``: bit-packed binarized rows, unpacked to {0,1};
    * ``image`` with ``data.dequantize``: uint8 levels; the input is the
      centred uniform-dequantized (x + u)/256, the target the bin centres
      x/255. u is ``u`` when given, else ``draw_u(shape)``;
    * ``image`` otherwise: float {0,1} (binarized); input == target.
    """
    if "image_packed" in batch:
        x = unpack_bits(batch["image_packed"], cfg.model.image_shape)
        return x, x
    image = batch["image"]
    if cfg.data.dequantize:
        if u is None:
            u = draw_u(image.shape)
        x_in = normalize_center(uniform_dequantize(image, u=u))
        return x_in, image.to(torch.float32) / 255.0
    x = image.to(torch.float32)
    return x, x


def _beta(cfg: Config, step: int) -> float:
    beta = float(cfg.train.beta)
    if cfg.train.beta_warmup_steps > 0:
        beta *= min(step / cfg.train.beta_warmup_steps, 1.0)
    return beta


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's noise: a function of (seed, step)."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 32)
                                         | int(words[1]))


def _loss_scale(cfg: Config) -> float:
    h, w, c = cfg.model.image_shape
    if cfg.train.loss_reduction == "mean_per_dim":
        return 1.0 / float(h * w * c)
    if cfg.train.loss_reduction == "sum":
        return 1.0
    raise ValueError(f"unknown loss_reduction {cfg.train.loss_reduction!r} "
                     "(sum|mean_per_dim)")


def _check_knobs(cfg: Config) -> None:
    """Raise on the combinations the reference refuses, and on every knob
    this slice does not run."""
    t, a = cfg.train, cfg.adversarial
    prior = cfg.model.prior
    if t.objective not in ("elbo", "iwae"):
        raise ValueError(f"unknown train.objective {t.objective!r} "
                         "(elbo|iwae)")
    if t.iwae_grad not in ("reparam", "dreg"):
        raise ValueError(f"unknown iwae grad estimator {t.iwae_grad!r} "
                         "(reparam|dreg)")
    if prior == "flow" and a.enabled:
        raise ValueError(
            "model.prior='flow' and adversarial.enabled are mutually "
            "exclusive: each is a complete reading of log p(z). "
            "model.prior='gaussian' is the trainable base that composes "
            "with the adversarial D.")
    if t.flow_dispersion_penalty > 0.0 and (prior != "flow"
                                            or t.objective != "elbo"):
        raise ValueError("train.flow_dispersion_penalty requires "
                         "model.prior='flow' and train.objective='elbo'")
    if t.objective == "iwae" and t.free_bits > 0.0:
        raise ValueError("train.free_bits applies to the elbo objective "
                         "only: the IWAE bound has no per-dimension KL term "
                         "to floor")
    unported = [
        ("adversarial.variant='biadversarial'",
         a.enabled and a.variant == "biadversarial"),
        ("adversarial.r1_gamma>0", a.enabled and a.r1_gamma > 0.0),
        ("adversarial.d_spectral_norm", a.enabled and a.d_spectral_norm),
        (f"adversarial.d_lr_schedule={a.d_lr_schedule!r}",
         a.enabled and a.d_lr_schedule != "constant"),
        ("train.ema_decay>0", t.ema_decay > 0.0),
        ("train.grad_accum>1", t.grad_accum > 1),
    ]
    for knob, on in unported:
        if on:
            raise NotImplementedError(f"{knob} is not ported to the PyTorch "
                                      "train step yet")


def g_objective(cfg: Config, model, d, x_in: torch.Tensor,
                x_target: torch.Tensor, beta: float, *,
                generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None,
                draw_u: Callable | None = None):
    """The G phase's ELBO loss -> (loss, aux, z).

    loss = −(mean(recon + w·adv(D(z))) − β·KL_obj − penalty)·scale: the
    KL against the model's prior (module docstring), KL_obj its batch
    mean or, with ``train.free_bits``, the prior's floor (per dimension
    for N(0, I) and the Gaussian base, on the total for the flow); the
    learned-prior term carries β (D(z) is part of log p*(z)). With
    ``train.flow_dispersion_penalty`` λ the penalty is
    λ·max(0, m_s/m_q − 1)², m_s the mean ‖z‖² of the flow's inverse on a
    fresh base draw u (``draw_u(shape)``) and m_q the batch posterior's,
    detached. aux holds the batch means recon, kl, elbo and, as they
    apply, g_adv and flow_dispersion. ``eps`` (CPU only) injects the
    reparameterization noise."""
    t = cfg.train
    prior = cfg.model.prior
    mean, logvar = model.encode(x_in)
    z = ops.reparam_sample(mean, logvar, generator=generator, eps=eps)
    out = model.decode(z)
    recon = L.recon_log_likelihood(x_target, out, cfg.model.likelihood)
    if prior == "flow":
        log_q = torch.sum(D.gaussian_logpdf(z, mean, logvar), dim=-1)
        kl = log_q - model.prior_logpdf(z)
    elif prior == "gaussian":
        mu_p, logvar_p = model.prior.mu, 2.0 * model.prior.log_sigma
        kl = torch.sum(D.gaussian_kl(mean, logvar, mu_p, logvar_p), dim=-1)
    else:
        kl = ops.kl_standard(mean, logvar)
    aux = {"recon": recon.mean(), "kl": kl.mean()}
    per_sample = recon
    if d is not None:
        a = cfg.adversarial
        adv_term = L.generator_adv_term(d(z), a.variant)
        adv_w = a.weight * beta if a.variant == "learned_prior" else a.weight
        per_sample = per_sample + adv_w * adv_term
        aux["g_adv"] = adv_term.mean()
    if t.free_bits > 0.0:
        if prior == "gaussian":
            kl_obj = L.free_bits_kl_gaussian_base(mean, logvar, mu_p,
                                                  logvar_p, t.free_bits)
        elif prior == "flow":
            kl_obj = L.free_information_kl(kl, cfg.model.z_dim, t.free_bits)
        else:
            kl_obj = L.free_bits_kl(mean, logvar, t.free_bits)
    else:
        kl_obj = kl.mean()
    objective = per_sample.mean() - beta * kl_obj
    if prior == "flow" and t.flow_dispersion_penalty > 0.0:
        z_s = model.prior_sample_from(draw_u(z.shape))
        m_s = torch.sum(z_s.square(), dim=-1).mean()
        m_q = torch.sum(z.detach().square(), dim=-1).mean()
        excess = torch.clamp_min(m_s / m_q - 1.0, 0.0)
        objective = objective - t.flow_dispersion_penalty * excess.square()
        aux["flow_dispersion"] = (m_s / m_q).detach()
    aux["elbo"] = (recon - kl).mean()
    return -objective * _loss_scale(cfg), aux, z


def g_objective_iwae(cfg: Config, model, d, x_in: torch.Tensor,
                     x_target: torch.Tensor, beta: float, *,
                     generator: torch.Generator | None = None,
                     eps: torch.Tensor | None = None):
    """The G phase's loss on the IWAE-k bound (``train.objective='iwae'``,
    ``losses.iwae_objective``) -> (loss, aux, z_q): aux adds the MC ELBO
    recon − kl for reporting, z_q is sample 0 [B, Z], detached."""
    a = cfg.adversarial
    objective, aux, z_q = L.iwae_objective(
        model, x_in, x_target, cfg.model.likelihood, cfg.train.iwae_k, beta,
        cfg.train.iwae_grad, trained_prior=cfg.model.prior != "standard",
        d=d, adv_variant=a.variant if d is not None else None,
        adv_weight=a.weight, generator=generator, eps=eps)
    aux["elbo"] = aux["recon"] - aux["kl"]
    return -objective * _loss_scale(cfg), aux, z_q


def make_train_fns(cfg: Config, *, device=None,
                   dtype: torch.dtype = torch.bfloat16) -> TrainFns:
    """The init, train and eval steps of ``cfg`` on ``device`` (``None``:
    the CUDA card, raising if there is none), computing in ``dtype``."""
    _check_knobs(cfg)
    _loss_scale(cfg)
    dev = resolve_device(device)
    adv = cfg.adversarial.enabled
    a = cfg.adversarial
    gauss_prior = cfg.model.prior == "gaussian"
    trainable_prior = cfg.model.prior in ("gaussian", "flow")
    noise_gen = torch.Generator(device=dev)

    def init_fn(seed: int) -> TrainState:
        model = build_model(cfg.model, dtype=dtype, device=dev, seed=seed)
        d = (make_latent_d(a, cfg.model.z_dim, device=dev, seed=seed + 1)
             if adv else None)
        return TrainState(
            step=0, model=model, opt=_make_optimizer(cfg, model.parameters()),
            d=d, d_opt=_make_d_optimizer(cfg, d.parameters()) if adv else None,
            seed=seed)

    def device_gen(gen: torch.Generator) -> torch.Generator:
        """The device generator, reseeded from the step's generator."""
        return noise_gen.manual_seed(int(torch.randint(0, 2 ** 63 - 1, (1,),
                                                       generator=gen)))

    def normal(shape, gen: torch.Generator) -> torch.Tensor:
        """N(0, I) on the device, seeded from the step's generator."""
        return torch.randn(shape, generator=device_gen(gen), device=dev)

    def uniform_fn(gen: torch.Generator) -> Callable:
        """shape -> U[0, 1) on the device, seeded from the step's
        generator when called."""
        return lambda shape: torch.rand(shape, generator=device_gen(gen),
                                        device=dev)

    def g_phase(state, x_in, x_target, beta, gen, eps, u_disp):
        if cfg.train.objective == "iwae":
            loss, aux, z = g_objective_iwae(cfg, state.model, state.d, x_in,
                                            x_target, beta, generator=gen,
                                            eps=eps)
        else:
            loss, aux, z = g_objective(
                cfg, state.model, state.d, x_in, x_target, beta,
                generator=gen, eps=eps,
                draw_u=lambda shape: (u_disp if u_disp is not None
                                      else normal(shape, gen)))
        grads = torch.autograd.grad(loss, state.opt.params)
        grad_norm = state.opt.step(grads)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        return metrics, z.detach()

    def d_phase(state, x_in, z_q, gen, d_eps, z_p):
        if z_q is None:
            # posterior samples with no gradient into the VAE
            with torch.no_grad():
                mean, logvar = state.model.encode(x_in)
                z_q = ops.reparam_sample(mean, logvar, generator=gen,
                                         eps=d_eps)
        if z_p is None:
            z_p = normal(z_q.shape, gen)
        if gauss_prior:
            # D separates q(z) from the model's own base N(μ, σ): the shaped
            # prior is p*(z) ∝ N(μ, σ)·e^{D(z)}; the base trains in G only
            with torch.no_grad():
                z_p = state.model.prior_sample_from(z_p)
        d_loss, d_acc = L.discriminator_loss(state.d(z_q), state.d(z_p),
                                             a.label_smoothing)
        state.d_opt.step(torch.autograd.grad(d_loss, state.d_opt.params))
        return {"d_loss": d_loss.detach(), "d_acc": d_acc}

    def train_step(state: TrainState, batch: dict, *,
                   noise: dict | None = None):
        """One step on a batch of device tensors, in place.

        ``noise`` (CPU tensors only): ``u`` [B, H, W, C] for the
        dequantization, ``eps`` [B, Z] for the G phase ([k, B, Z] under
        the IWAE objective), ``u_disp`` [B, Z] for the flow dispersion
        penalty, ``z_p`` [n_critic, B, Z] for the critic steps and, with
        ``d_reuse_posterior=False``, ``d_eps`` [n_critic, B, Z]."""
        if noise is not None and dev.type != "cpu":
            raise ValueError("train_step: noise is accepted only on the CPU; "
                             "on CUDA the kernels draw it")
        noise = noise or {}
        gen = step_generator(state.seed, state.step)
        x_in, x_target = prepare_batch(cfg, batch, uniform_fn(gen),
                                       noise.get("u"))
        beta = _beta(cfg, state.step)
        metrics: dict = {}

        def run_d_phases(z_q):
            d_ms = []
            for i in range(a.n_critic):
                d_ms.append(d_phase(
                    state, x_in, z_q, gen,
                    noise["d_eps"][i] if "d_eps" in noise else None,
                    noise["z_p"][i] if "z_p" in noise else None))
            if d_ms:
                metrics.update({k: torch.stack([m[k] for m in d_ms]).mean()
                                for k in d_ms[0]})

        if adv and not a.d_reuse_posterior:
            run_d_phases(None)          # reference order: D, then G
        g_metrics, z_q = g_phase(state, x_in, x_target, beta, gen,
                                 noise.get("eps"), noise.get("u_disp"))
        metrics.update(g_metrics)
        if adv and a.d_reuse_posterior:
            # G then D: D sees z_q drawn under the pre-update params
            run_d_phases(z_q)
        metrics["beta"] = beta
        state.step += 1
        return state, metrics

    def eval_step(state: TrainState, batch: dict) -> dict:
        """Single-sample ELBO on a batch; deterministic in (seed, batch).
        With a trained prior the KL is the MC log q(z|x) − log p_θ(z)."""
        gen = step_generator(state.seed, 0x7FFFFFFF)
        x_in, x_target = prepare_batch(cfg, batch, uniform_fn(gen))
        model = state.model
        with torch.no_grad():
            if trainable_prior:
                mean, logvar = model.encode(x_in)
                z = ops.reparam_sample(mean, logvar, generator=gen)
                recon = L.recon_log_likelihood(x_target, model.decode(z),
                                               cfg.model.likelihood)
                kl = (torch.sum(D.gaussian_logpdf(z, mean, logvar), dim=-1)
                      - model.prior_logpdf(z))
            else:
                recon, kl, _ = L.elbo_terms(model.encode, model.decode, x_in,
                                            x_target, cfg.model.likelihood,
                                            generator=gen)
        return {"valid_elbo": (recon - kl).mean(),
                "valid_recon": recon.mean(), "valid_kl": kl.mean()}

    return TrainFns(init_fn=init_fn, train_step=train_step,
                    eval_step=eval_step, device=dev)
