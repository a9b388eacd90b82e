"""The train step: the ELBO or the IWAE-k bound, with the model's own
prior (N(0, I), a trained Gaussian base or a trained flow) and the
adversarial latent prior, G phase then D phase, each with its own clipped
Adam (counterpart of ``apv_tpu/training/step.py``).

The step is one skeleton, ``make_train_fns``, with the model family's
step behind it: ``EncodeDecodeStep`` below for the encode -> z -> decode
families (conv, resnet), ``training/vdvae.VDVAEStep`` for the hierarchical
one. The skeleton keeps what no family changes: the step's generator, the
device draws, the block, the check that every key was taken, the EMA and
the step count. The family object keeps the rest: its refusals (its
constructor; the combinations the reference refuses raise ``ValueError``),
``init`` -> (optimizer, D, D's optimizer), ``draw`` -> its (keys, host
numbers, device draws) in its order, none for an entry of ``noise``,
``critic`` (D's optimizer calls a step), ``step`` (its input stage, loss,
optimizer calls and metrics) and ``eval_step`` (its validation ELBO).

The reference jits both phases into one XLA program; here the
reparameterized sample, the KL and the Bernoulli and discretized-logistic
likelihoods are hand-written kernels whose backward is a kernel too
(``ops/dispatch.py``). The input stage runs on the batch's device: bit
unpacking for the binarized MNIST configs, uniform dequantization of uint8
levels for CIFAR. Gradient discipline as in the reference: the G phase
differentiates only the VAE's parameters (D's are constants there, and
``torch.autograd.grad`` leaves their ``.grad`` untouched); the D phase
differentiates only D's, on posterior samples that carry no gradient.

Noise: step ``t`` of a run with seed ``s`` draws everything from a CPU
``torch.Generator`` seeded by (s, t) alone, the counterpart of
``fold_in(rng, step)``: never the global generator, so a step can be
replayed. The draws come in a fixed order: the dequantization u, then the
G phase's ε (one reparameterization key, k samples a row under the IWAE
objective), then the flow dispersion penalty's base draw u (the
reference's ``fold_in(key, 1)``; drawn only when the penalty is on), then
the critic's z_p (the u's and z_p on the device, from a device generator
reseeded from the step's generator); with ``d_reuse_posterior=False``
each critic step's key and z_p come first. On CPU tensors ``train_step``
also takes the noise injected (``noise=``), which the parity tests use to
hand the port JAX's draws.

A step is ``draw`` then ``run``. ``draw`` takes every number the host
chooses for the step, in that order: the device draws, and one int64
block through pinned memory (``HostBlock``) of the keys, which the reparam
kernels read on the device, and the float32 numbers: β, then each
optimizer call's ``hyper``. ``run`` is the device work on them and
advances the host's counts; reading no host number that changes from step
to step, it can be captured in a CUDA graph once and replayed
(``training/graph.py``).

The model's prior: the flow takes the single-sample MC KL log q(z|x) −
log p_θ(z), the Gaussian base the analytic KL against (μ, 2·log σ), the
standard prior the KL kernel. The prior's parameters are part of
``model.parameters()``, so the G optimizer clips and updates them with the
VAE's, as optax does with one param tree. With the Gaussian base the D
phase draws z_p from the (detached) base.

The discriminators: the latent D may be spectrally normalized
(``adversarial.d_spectral_norm``). Under ``variant='biadversarial'`` the
state's D is the pair ``{"latent", "pixel"}`` with one ``ClippedAdam`` over
both, as the reference shares one optimizer and one n_critic schedule.
The pixel and R1 terms are ``g_objective``'s and ``d_objective``'s; the D
phase reuses the G phase's x̂ (or decodes its own z_q).

The training knobs: ``adversarial.d_lr_schedule`` 'cosine' decays D's
learning rate over its updates (``_make_d_optimizer``); 'floor_adaptive'
multiplies each applied D update by a factor from that D's loss
(``d_lr_factor``; Adam's moments still take the full gradient).
``train.grad_accum`` k averages both optimizers' gradients over k
micro-steps and applies them on the k-th (``ClippedAdam``'s ``every_k``;
D's micro-steps are its critic iterations). ``train.ema_decay`` d keeps
the VAE's Polyak average in ``state.ema_model`` (the optimizer's ``ema_``)
once per micro-step after the D phases; validation reads the raw
parameters.

Data parallelism: under a process group (``parallel/multihost.py``) each
rank runs the step on its rows of the global batch, and the step averages
each phase's gradients over the group between ``torch.autograd.grad`` and
the optimizer (``multihost.average_``): clip, Adam and ``grad_norm`` see
the global gradient. The floor-adaptive factors come from the group mean
of the D losses, carried in D's bucket, as the reference's global-batch
loss gives them: a factor from the local loss would let the replicas drift
apart. The statistics that the loss takes of a whole batch before a
nonlinearity (the free-bits floors, the dispersion penalty's mean norms)
are replaced by their group means with the gradient passed through to the
local ones (``multihost.group_batch_mean``), so the averaged gradient is
the global batch's. With more than one rank the rank is folded into each
step's generator (and the eval step's), so the ranks draw distinct noise;
a group of one draws what no group draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core import distributions as D
from apv_tpu_torch.data.preprocess import (normalize_center,
                                           uniform_dequantize, unpack_bits)
from apv_tpu_torch.models import (build_model, latent_d_params,
                                  make_discriminators)
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.training import losses as L
from apv_tpu_torch.training.optim import (ClippedAdam, constant, cosine_decay,
                                          warmup_cosine_decay)
from apv_tpu_torch.training.state import TrainState
from apv_tpu_torch.training.vdvae import VDVAEStep
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device
from apv_tpu_torch.utils.logging import span, waits


class TrainFns(NamedTuple):
    init_fn: Callable[[int], TrainState]
    # (state, batch, *, noise=None) -> (state, metrics); updates in place
    train_step: Callable[..., tuple[TrainState, dict]]
    eval_step: Callable[[TrainState, dict], dict]
    device: torch.device
    # train_step's two parts: (state, batch, *, noise=None, out=None) ->
    # the step's inputs, and (state, batch, inputs) -> (state, metrics)
    draw: Callable[..., dict]
    run: Callable[[TrainState, dict, dict], tuple[TrainState, dict]]


def host_words(keys: list, numbers: list[float]) -> np.ndarray:
    """A step's block as int64 words: the keys' (seed, offset) pairs,
    then the numbers as float32, two a word."""
    f = np.zeros(2 * ((len(numbers) + 1) // 2), np.float32)
    f[:len(numbers)] = numbers
    return np.concatenate([np.asarray(keys, np.int64).reshape(-1),
                           f.view(np.int64)])


class HostBlock:
    """A step's block of host numbers on its way to the device. On a CUDA
    device through pinned memory with ``non_blocking=True``: one slot per
    step of a call (``train.steps_per_call``), each taken again only once
    the device has read it (its copy's event; the host waits there, a
    synchronising call, where it runs that far ahead), so the host never
    overwrites a slot that a queued step has not read."""

    def __init__(self, device: torch.device, slots: int):
        self.device, self.slots = device, max(1, slots)
        self.pinned = self.host = None
        self.events: list = []
        self.at = 0

    def put(self, words: np.ndarray, out: torch.Tensor | None = None
            ) -> torch.Tensor:
        """``words`` on the device: in ``out`` (in place) or a new
        tensor."""
        if self.device.type != "cuda":
            t = torch.from_numpy(words)
            return t if out is None else out.copy_(t)
        if self.pinned is None:
            self.pinned = torch.empty((self.slots, words.size),
                                      dtype=torch.int64, pin_memory=True)
            self.host = self.pinned.numpy()
            self.events = [None] * self.slots
        i, self.at = self.at, (self.at + 1) % self.slots
        ev = self.events[i]
        if ev is not None and not ev.query():
            with waits("staging", idle=False):
                ev.synchronize()
        self.host[i] = words
        if out is None:
            out = torch.empty(words.size, dtype=torch.int64,
                              device=self.device)
        out.copy_(self.pinned[i], non_blocking=True)
        if ev is None:
            ev = self.events[i] = torch.cuda.Event()
        ev.record()
        return out


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
    return ClippedAdam(params, lr, clip_norm=t.grad_clip_norm,
                       b2=t.adam_b2, every_k=t.grad_accum)


D_LR_SCHEDULES = ("constant", "cosine", "floor_adaptive")


def _make_d_optimizer(cfg: Config, params) -> ClippedAdam:
    """D's Adam: b1 = 0.5 (GAN convention), own clip, d_lr constant or
    cosine-decayed to d_lr_end over D's updates ('floor_adaptive' keeps
    it constant and throttles the update in the D phase)."""
    a, t = cfg.adversarial, cfg.train
    lr = constant(a.d_lr)
    if a.d_lr_schedule == "cosine":
        d_updates = max(1, t.steps // t.grad_accum) * max(1, a.n_critic)
        lr = cosine_decay(a.d_lr, d_updates, alpha=a.d_lr_end / a.d_lr)
    return ClippedAdam(params, lr, clip_norm=t.grad_clip_norm, b1=0.5,
                       every_k=t.grad_accum)


def d_lr_factor(cfg: Config, loss: torch.Tensor) -> torch.Tensor:
    """The floor-adaptive throttle of a D update, from that D's loss:
    clip((loss − floor)/(2 ln 2 − floor), 0, 1) on the loss's device."""
    floor = L.d_loss_floor(cfg.adversarial.label_smoothing)
    return torch.clamp((loss.detach() - floor) / (2.0 * np.log(2.0) - floor),
                       0.0, 1.0)


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


def step_generator(seed: int, step: int,
                   rank: int | None = None) -> torch.Generator:
    """The CPU generator of one step's noise: a function of (seed, step),
    and of the rank when one is given (data parallelism over more than one
    rank)."""
    entropy = [seed, step] + ([] if rank is None else [rank])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 32)
                                         | int(words[1]))


def host_seed(gen: torch.Generator) -> int:
    """One draw of the step's generator, the seed of a device draw."""
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=gen))


def sync_d(grads: list[torch.Tensor], losses: list[torch.Tensor]) -> None:
    """Average D's gradients and the detached losses of its throttle over
    the group, in place, in one bucket."""
    multihost.average_(grads + losses)


def _check_knobs(cfg: Config) -> None:
    """Raise on the combinations the reference refuses, in every family."""
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
    if a.enabled and a.d_lr_schedule not in D_LR_SCHEDULES:
        raise ValueError(f"adversarial.d_lr_schedule must be 'constant', "
                         f"'cosine', or 'floor_adaptive', got "
                         f"{a.d_lr_schedule!r}")
    if t.grad_accum < 1:
        raise ValueError(f"train.grad_accum must be >= 1, got "
                         f"{t.grad_accum}")


def g_objective(cfg: Config, model, d, x_in: torch.Tensor,
                x_target: torch.Tensor, beta: float, *,
                generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None,
                draw_u: Callable | None = None, px: Callable | None = None):
    """The G phase's ELBO loss -> (loss, aux, z).

    loss = −(mean(recon + w·adv(D(z))) − β·KL_obj − penalty)·scale: the
    KL against the model's prior (module docstring), KL_obj its batch
    mean or, with ``train.free_bits``, the prior's floor (per dimension
    for N(0, I) and the Gaussian base, on the total for the flow); the
    learned-prior term carries β (D(z) is part of log p*(z)), for the
    biadversarial variant too. ``px`` (the pixel D) adds the β-free
    ``pixel_weight``·log σ(D_x(x̂)) and puts ``g_px`` and x̂ (``x_hat``,
    detached, for the D phase) in aux. With
    ``train.flow_dispersion_penalty`` λ the penalty is
    λ·max(0, m_s/m_q − 1)², m_s the mean ‖z‖² of the flow's inverse on a
    fresh base draw u (``draw_u(shape)``) and m_q the batch posterior's,
    detached. aux holds the batch means recon, kl, elbo and, as they
    apply, g_adv and flow_dispersion. ``eps`` (CPU only) injects the
    reparameterization noise."""
    t = cfg.train
    prior = cfg.model.prior
    mean, logvar = model.encode(x_in)
    if prior in ("flow", "gaussian"):
        z = ops.reparam_sample(mean, logvar, generator=generator, eps=eps)
    else:                     # N(0, I): z and the analytic KL together
        z, kl = ops.reparam_kl(mean, logvar, generator=generator, eps=eps)
    out = model.decode(z)
    recon = L.recon_log_likelihood(x_target, out, cfg.model.likelihood)
    if prior == "flow":
        log_q = torch.sum(D.gaussian_logpdf(z, mean, logvar), dim=-1)
        kl = log_q - model.prior_logpdf(z)
    elif prior == "gaussian":
        mu_p, logvar_p = model.prior.mu, 2.0 * model.prior.log_sigma
        kl = torch.sum(D.gaussian_kl(mean, logvar, mu_p, logvar_p), dim=-1)
    aux = {"recon": recon.mean(), "kl": kl.mean()}
    per_sample = recon
    if d is not None:
        a = cfg.adversarial
        adv_term = L.generator_adv_term(d(z), a.variant)
        adv_w = (a.weight * beta
                 if a.variant in ("learned_prior", "biadversarial")
                 else a.weight)
        per_sample = per_sample + adv_w * adv_term
        aux["g_adv"] = adv_term.mean()
    if px is not None:
        x_hat = L.likelihood_pixel_mean(out, cfg.model.likelihood,
                                        x_target.shape[-1])
        px_term = L.pixel_g_term(px(x_hat))
        per_sample = per_sample + cfg.adversarial.pixel_weight * px_term
        aux["g_px"] = px_term.mean()
        aux["x_hat"] = x_hat.detach()
    gm = multihost.group_batch_mean
    if t.free_bits > 0.0:
        if prior == "gaussian":
            kl_obj = L.free_bits_kl_gaussian_base(mean, logvar, mu_p,
                                                  logvar_p, t.free_bits, gm)
        elif prior == "flow":
            kl_obj = L.free_information_kl(kl, cfg.model.z_dim, t.free_bits,
                                           gm)
        else:
            kl_obj = L.free_bits_kl(mean, logvar, t.free_bits, gm)
    else:
        kl_obj = kl.mean()
    objective = per_sample.mean() - beta * kl_obj
    if prior == "flow" and t.flow_dispersion_penalty > 0.0:
        z_s = model.prior_sample_from(draw_u(z.shape))
        m_s = gm(torch.sum(z_s.square(), dim=-1).mean())
        m_q = gm(torch.sum(z.detach().square(), dim=-1).mean())
        excess = torch.clamp_min(m_s / m_q - 1.0, 0.0)
        objective = objective - t.flow_dispersion_penalty * excess.square()
        aux["flow_dispersion"] = (m_s / m_q).detach()
    aux["elbo"] = (recon - kl).mean()
    return -objective * L.loss_scale(cfg), aux, z


def g_objective_iwae(cfg: Config, model, d, x_in: torch.Tensor,
                     x_target: torch.Tensor, beta: float, *,
                     generator: torch.Generator | None = None,
                     eps: torch.Tensor | None = None,
                     px: Callable | None = None):
    """The G phase's loss on the IWAE-k bound (``train.objective='iwae'``,
    ``losses.iwae_objective``, with the pixel D ``px`` under the
    biadversarial variant) -> (loss, aux, z_q): aux adds the MC ELBO
    recon − kl for reporting, z_q is sample 0 [B, Z], detached."""
    a = cfg.adversarial
    objective, aux, z_q = L.iwae_objective(
        model, x_in, x_target, cfg.model.likelihood, cfg.train.iwae_k, beta,
        cfg.train.iwae_grad, trained_prior=cfg.model.prior != "standard",
        d=d, adv_variant=a.variant if d is not None else None,
        adv_weight=a.weight, px=px, px_weight=a.pixel_weight,
        generator=generator, eps=eps)
    aux["elbo"] = aux["recon"] - aux["kl"]
    return -objective * L.loss_scale(cfg), aux, z_q


def d_objective(cfg: Config, d, z_q: torch.Tensor, z_p: torch.Tensor,
                x_target: torch.Tensor, x_hat: torch.Tensor | None):
    """The D phase's loss -> (total, metrics): the latent BCE on {z_q real,
    z_p fake} (``d_loss``, ``d_acc``); with ``adversarial.r1_gamma`` γ,
    γ·R1 on z_q (``d_r1``); under the biadversarial variant (``d`` the
    pair) the pixel BCE on {x_target real, x̂ fake} (``px_d_loss``,
    ``px_d_acc``) and γ·R1 on x_target (``px_d_r1``). The metrics keep
    their graphs; ``total`` is differentiable in D's parameters."""
    a = cfg.adversarial
    lat = latent_d_params(a.variant, d)
    d_loss, d_acc = L.discriminator_loss(lat(z_q), lat(z_p),
                                         a.label_smoothing)
    metrics = {"d_loss": d_loss, "d_acc": d_acc}
    total = d_loss
    if a.r1_gamma > 0.0:
        metrics["d_r1"] = r1 = L.r1_penalty(lat, z_q)
        total = total + a.r1_gamma * r1
    if a.variant == "biadversarial":
        px = d["pixel"]
        px_loss, px_acc = L.discriminator_loss(px(x_target), px(x_hat),
                                               a.label_smoothing)
        metrics.update(px_d_loss=px_loss, px_d_acc=px_acc)
        total = total + px_loss
        if a.r1_gamma > 0.0:
            metrics["px_d_r1"] = px_r1 = L.r1_penalty(px, x_target)
            total = total + a.r1_gamma * px_r1
    return total, metrics


class EncodeDecodeStep:
    """The encode -> z -> decode families' step (conv, resnet): the G
    phase on the ELBO or the IWAE bound, D's phases in the reference's
    order with the throttle, and the validation ELBO."""

    def __init__(self, cfg: Config):
        a = cfg.adversarial
        self.cfg, self.a, self.adv = cfg, a, a.enabled
        self.biadv = self.adv and a.variant == "biadversarial"
        self.throttle = self.adv and a.d_lr_schedule == "floor_adaptive"
        self.penalty = (cfg.model.prior == "flow"
                        and cfg.train.flow_dispersion_penalty > 0.0)
        self.critic = a.n_critic if self.adv else 0     # D's calls a step

    def init(self, model, seed: int, dtype: torch.dtype, dev) -> tuple:
        opt = _make_optimizer(self.cfg, model.parameters())
        if not self.adv:
            return opt, None, None
        d = make_discriminators(self.a, self.cfg.model.z_dim,
                                self.cfg.model.image_shape, device=dev,
                                seed=seed + 1, dtype=dtype)
        return opt, d, _make_d_optimizer(self.cfg, d.parameters())

    def draw(self, state: TrainState, batch: dict, noise: dict,
             gen: torch.Generator) -> tuple[list, list, list]:
        cfg, a, critic = self.cfg, self.a, range(self.critic)
        keys, zp, disp = [], [], None
        u = (host_seed(gen) if cfg.data.dequantize and "u" not in noise
             and "image_packed" not in batch else None)
        if self.adv and not a.d_reuse_posterior:    # D's phases come first
            for _ in critic:
                if "d_eps" not in noise:
                    keys.append(K.draw_key(gen))
                if "z_p" not in noise:
                    zp.append(host_seed(gen))
        if "eps" not in noise:
            keys.append(K.draw_key(gen))
        if self.penalty and "u_disp" not in noise:
            disp = host_seed(gen)
        if self.adv and a.d_reuse_posterior and "z_p" not in noise:
            zp = [host_seed(gen) for _ in critic]
        rz = (next(iter(batch.values())).shape[0], cfg.model.z_dim)
        draws = [] if u is None else [("u", batch["image"].shape, u, False)]
        if zp:
            draws.append(("z_p", rz, zp, True))
        if disp is not None:
            draws.append(("u_disp", rz, disp, True))
        return keys, [_beta(cfg, state.step)], draws

    def g_phase(self, state, x_in, x_target, beta, keys, eps, u_disp,
                hyper):
        cfg = self.cfg
        lat = latent_d_params(self.a.variant, state.d)
        px = state.d["pixel"] if self.biadv else None
        if cfg.train.objective == "iwae":
            loss, aux, z = g_objective_iwae(cfg, state.model, lat, x_in,
                                            x_target, beta, generator=keys,
                                            eps=eps, px=px)
        else:
            loss, aux, z = g_objective(
                cfg, state.model, lat, x_in, x_target, beta,
                generator=keys, eps=eps, draw_u=lambda shape: u_disp, px=px)
        x_hat = aux.pop("x_hat", None)
        grads = torch.autograd.grad(loss, state.opt.params)
        multihost.average_(list(grads))
        with span("step.g_opt"):
            grad_norm = state.opt.step(grads, hyper=hyper)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        return metrics, z.detach(), x_hat

    def d_phase(self, state, x_in, x_target, z_q, x_hat, keys, d_eps, z_p,
                hyper):
        cfg = self.cfg
        if z_q is None:
            # posterior samples with no gradient into the VAE
            with torch.no_grad():
                mean, logvar = state.model.encode(x_in)
                z_q = ops.reparam_sample(mean, logvar, generator=keys,
                                         eps=d_eps)
        if cfg.model.prior == "gaussian":
            # D separates q(z) from the model's own base N(μ, σ): the shaped
            # prior is p*(z) ∝ N(μ, σ)·e^{D(z)}; the base trains in G only
            with torch.no_grad():
                z_p = state.model.prior_sample_from(z_p)
        if self.biadv and x_hat is None:
            with torch.no_grad():
                x_hat = L.likelihood_pixel_mean(
                    state.model.decode(z_q), cfg.model.likelihood,
                    x_target.shape[-1])
        total, metrics = d_objective(cfg, state.d, z_q, z_p, x_target,
                                     x_hat)
        grads = list(torch.autograd.grad(total, state.d_opt.params))
        # the throttle's losses: the group's means under a process group
        losses = ([metrics[n].detach().clone() for n in ("d_loss", "px_d_loss")
                   if n in metrics] if self.throttle else [])
        sync_d(grads, losses)
        scales = None
        if self.throttle:
            # one factor a D, each from its own loss, on the device
            metrics["d_lr_factor"] = f = d_lr_factor(cfg, losses[0])
            if self.biadv:
                metrics["px_d_lr_factor"] = pf = d_lr_factor(cfg, losses[1])
                scales = ([f for _ in state.d["latent"].parameters()]
                          + [pf for _ in state.d["pixel"].parameters()])
            else:
                scales = [f] * len(grads)
        with span("step.d_opt"):
            state.d_opt.step(grads, scales, hyper=hyper)
        return {k: v.detach() for k, v in metrics.items()}

    def step(self, state: TrainState, batch: dict, inputs: dict,
             keys: K.StepKeys) -> dict:
        """D's phases and G's in the reference's order -> metrics."""
        a = self.a
        x_in, x_target = prepare_batch(self.cfg, batch, None, inputs.get("u"))
        hyper = inputs["hyper"]
        beta = hyper[0]
        g_end = 1 + state.opt.HYPER
        metrics: dict = {}

        def run_d_phases(z_q, x_hat):
            d_ms, n = [], ClippedAdam.HYPER
            for i in range(a.n_critic):
                with span("step.d_phase", marks="start"):
                    d_ms.append(self.d_phase(
                        state, x_in, x_target, z_q, x_hat, keys,
                        inputs["d_eps"][i] if "d_eps" in inputs else None,
                        inputs["z_p"][i],
                        hyper[g_end + n * i:g_end + n * (i + 1)]))
            if d_ms:
                metrics.update({k: torch.stack([m[k] for m in d_ms]).mean()
                                for k in d_ms[0]})

        if self.adv and not a.d_reuse_posterior:
            run_d_phases(None, None)    # reference order: D, then G
        with span("step.g_phase", marks="start"):
            g_metrics, z_q, x_hat = self.g_phase(
                state, x_in, x_target, beta, keys, inputs.get("eps"),
                inputs.get("u_disp"), hyper[1:g_end])
        metrics.update(g_metrics)
        if self.adv and a.d_reuse_posterior:
            # G then D: D sees z_q (and x̂) made under the pre-update params
            run_d_phases(z_q, x_hat)
        metrics["beta"] = beta
        return metrics

    def eval_step(self, state: TrainState, batch: dict,
                  gen: torch.Generator, draw_u: Callable) -> dict:
        """Single-sample ELBO; with a trained prior the KL is the MC
        log q(z|x) − log p_θ(z)."""
        cfg, model = self.cfg, state.model
        x_in, x_target = prepare_batch(cfg, batch, draw_u)
        with torch.no_grad():
            if cfg.model.prior in ("gaussian", "flow"):
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


def make_train_fns(cfg: Config, *, device=None,
                   dtype: torch.dtype = torch.bfloat16) -> TrainFns:
    """The init, train and eval steps of ``cfg`` on ``device`` (``None``:
    the CUDA card, raising if there is none), computing in ``dtype``."""
    _check_knobs(cfg)
    family = (VDVAEStep if cfg.model.family == "vdvae"
              else EncodeDecodeStep)(cfg)
    L.loss_scale(cfg)
    dev = resolve_device(device)
    noise_gen = torch.Generator(device=dev)
    staging = HostBlock(dev, cfg.train.steps_per_call)
    ema_decay = cfg.train.ema_decay
    fold = (multihost.process_index() if multihost.process_count() > 1
            else None)                 # the rank in each step's generator

    def init_fn(seed: int) -> TrainState:
        model = build_model(cfg.model, dtype=dtype, device=dev, seed=seed)
        ema = None
        if ema_decay > 0.0:
            ema = build_model(cfg.model, dtype=dtype, device=dev, seed=seed)
            ema.load_state_dict(model.state_dict())
            ema.requires_grad_(False)
        opt, d, d_opt = family.init(model, seed, dtype, dev)
        return TrainState(step=0, model=model, opt=opt, d=d, d_opt=d_opt,
                          seed=seed, ema_model=ema)

    def fill(t: torch.Tensor | None, shape, seed: int | list[int],
             normal: bool) -> torch.Tensor:
        """``t`` (or a new float32 tensor of ``shape``) filled with the
        draw of the device generator reseeded with ``seed``: N(0, I) or
        U[0, 1), the bits of ``torch.randn``/``torch.rand``; with a list
        of seeds a stack [len, *shape], row i drawn from seed i."""
        if isinstance(seed, list):
            if t is None:
                t = torch.empty((len(seed), *shape), device=dev)
            for row, s in zip(t, seed):
                fill(row, None, s, normal)
            return t
        if t is None:
            t = torch.empty(shape, dtype=torch.float32, device=dev)
        g = noise_gen.manual_seed(seed)
        return t.normal_(generator=g) if normal else t.uniform_(generator=g)

    def draw(state: TrainState, batch: dict, *, noise: dict | None = None,
             out: dict | None = None) -> dict:
        """The step's inputs that the host chooses (module docstring); a
        family's device draw is ``fill``'s (name, shape, seed, normal).
        ``out`` (an earlier ``draw``'s dict) is written in place."""
        noise, out = noise or {}, out or {}
        gen = step_generator(state.seed, state.step, fold)
        keys, numbers, draws = family.draw(state, batch, noise, gen)
        numbers = numbers + state.opt.hyper()[0]
        if state.d_opt is not None:
            for h in state.d_opt.hyper(family.critic):
                numbers += h
        inputs = dict(noise)
        for name, shape, seed, normal in draws:
            inputs[name] = fill(out.get(name), shape, seed, normal)
        block = staging.put(host_words(keys, numbers), out.get("block"))
        n = 2 * len(keys)
        inputs.update(block=block, keys=block[:n].view(len(keys), 2),
                      hyper=block[n:].view(torch.float32)[:len(numbers)])
        return inputs

    def run(state: TrainState, batch: dict, inputs: dict):
        """One step on a batch and ``draw``'s inputs, in place: the
        family's step, the Polyak average, the host's counts advanced."""
        keys = K.StepKeys(inputs["keys"])
        metrics = family.step(state, batch, inputs, keys)
        if state.ema_model is not None:
            with span("step.ema", marks="start"):
                state.opt.ema_(state.ema_model.parameters(), ema_decay)
        if keys.taken != keys.keys.shape[0]:
            raise RuntimeError(f"the step drew {keys.taken} of its "
                               f"{keys.keys.shape[0]} reparameterization "
                               "keys")
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, batch: dict, *,
                   noise: dict | None = None):
        """One step on a batch of device tensors, in place: ``draw`` then
        ``run``.

        ``noise`` (CPU tensors only): ``u`` [B, H, W, C] for the
        dequantization, ``eps`` [B, Z] for the G phase ([k, B, Z] under
        the IWAE objective), ``u_disp`` [B, Z] for the flow dispersion
        penalty, ``z_p`` [n_critic, B, Z] for the critic steps and, with
        ``d_reuse_posterior=False``, ``d_eps`` [n_critic, B, Z]; under the
        vdvae family ``eps``, a list of each layer's [B, Z, r, r]."""
        if noise is not None and dev.type != "cpu":
            raise ValueError("train_step: noise is accepted only on the CPU; "
                             "on CUDA the kernels draw it")
        return run(state, batch, draw(state, batch, noise=noise))

    def eval_step(state: TrainState, batch: dict) -> dict:
        """The family's single-sample validation ELBO on a batch;
        deterministic in (seed, batch)."""
        gen = step_generator(state.seed, 0x7FFFFFFF, fold)
        return family.eval_step(state, batch, gen, lambda shape: fill(
            None, shape, host_seed(gen), False))

    return TrainFns(init_fn=init_fn, train_step=train_step,
                    eval_step=eval_step, device=dev, draw=draw, run=run)
