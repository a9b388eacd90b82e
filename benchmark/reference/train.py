"""The reference's training steps of an adversarial-prior VAE.

A step, for the ELBO under N(0, I) with the learned adversarial prior
p*(z) ∝ N(0, I)·e^{D(z)} (the flagship's configuration):

* the batch of step t: ``batch_rows`` (an epoch of N // B batches is one
  more shuffle of the train set's rows by ``numpy.random.default_rng``);
* the input: uint8 levels x, dequantized (x + u)/256 with u ~ U[0, 1) from
  the step's device generator, centred to [−1, 1]; the target x/255;
* G: z = μ + e^{lv/2}·ε, ε from the step's key; loss = −(mean(recon +
  w·β·D(z)) − β·mean(KL)), β = β₀·min(t / warmup, 1); the gradient of the
  VAE's parameters only, clipped to a global norm of ``grad_clip_norm``,
  then Adam (0.9, 0.999, 1e-8) at a warmup-cosine learning rate from 0;
* D, after G: the BCE of D on {z detached: 1, z_p ~ N(0, I) from the
  step's device generator: 0} with label smoothing s, clipped, then Adam
  (0.5, 0.999, 1e-8) at ``d_lr``.

``follow`` starts at step ``start``: the weights as given, both
optimizers' moments zero and their counts at ``start``, as a run that
took ``start`` steps has them counted (so β and the learning rate are
those of that step). It returns each step's two losses, its batch means
of the KL and of D(z) as the G phase computes them before β scales them
(and the batch's standard deviation of D(z), its scale),
the first step's gradients as the optimizers take them (after the clip)
and the parameters after the last step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import likelihood as L
from benchmark.reference import models, stream


def warmup_cosine(init: float, peak: float, warmup: int, decay: int,
                  end: float):
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(count: int) -> float:
        if count < warmup:
            return (init - peak) * (1.0 - count / warmup) + peak
        t = min(count - warmup, decay - warmup)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(
            math.pi * t / (decay - warmup))) + alpha)
    return lr


class Adam:
    def __init__(self, params: list[torch.Tensor], lr, clip: float,
                 b1: float, b2: float = 0.999, eps: float = 1e-8,
                 count: int = 0):
        self.params, self.lr, self.clip = params, lr, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = count

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], move: bool = True
             ) -> list[torch.Tensor]:
        """Clip, update (the moments and count alone unless ``move``), and
        return the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        grads = [g * scale for g in grads]
        t = self.count + 1
        lr = self.lr(self.count)
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat = m / (1.0 - self.b1 ** t)
            v_hat = v / (1.0 - self.b2 ** t)
            if move:
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        self.count = t
        return grads


def check_supported(cfg: dict) -> None:
    t, a, m, dt = cfg["train"], cfg["adversarial"], cfg["model"], cfg["data"]
    wanted = [(t["objective"] == "elbo", "train.objective elbo"),
              (m.get("prior", "standard") == "standard", "standard prior"),
              (t["free_bits"] == 0.0, "no free bits"),
              (t["grad_accum"] == 1, "no gradient accumulation"),
              (t["ema_decay"] == 0.0, "no EMA"),
              (t["loss_reduction"] == "sum", "loss_reduction sum"),
              (not a["enabled"] or (a["variant"] == "learned_prior"
                                    and a["n_critic"] == 1
                                    and a["d_reuse_posterior"]
                                    and a["r1_gamma"] == 0.0
                                    and a["d_lr_schedule"] == "constant"),
               "the learned prior, one critic step after G, no R1, a "
               "constant D learning rate"),
              (dt["dequantize"] and not dt["binarize"],
               "dequantized uint8 levels")]
    missing = [what for ok, what in wanted if not ok]
    if missing:
        raise ValueError(f"the reference train step covers only: {missing}")


def batch_rows(n: int, batch: int, seed: int, step: int) -> np.ndarray:
    """The rows of step ``step``: batch ``step % (n // batch)`` of epoch
    ``step // (n // batch)``, each epoch one more shuffle of ``arange(n)``
    by ``numpy.random.default_rng(seed)``, the remainder dropped."""
    per_epoch = n // batch
    rng = np.random.default_rng(seed)
    for _ in range(step // per_epoch + 1):
        idx = np.arange(n)
        rng.shuffle(idx)
    at = (step % per_epoch) * batch
    return idx[at:at + batch]


FAULTS = ("no_kl_grad", "no_adv_grad", "state_unchanged")


def follow(cfg: dict, w_vae: dict, w_d: dict, images: torch.Tensor,
           steps: int, seed: int, prec: models.Precision | None = None,
           rows: int | None = None, start: int = 0,
           fault: str | None = None) -> dict:
    """Run ``steps`` steps from step ``start`` and the weights ``w_vae``,
    ``w_d`` on ``images`` (uint8 [N, H, W, C] on the device that
    computes). Planted faults: ``rows`` keeps the first ``rows`` of each
    batch (after its noise is drawn) and takes the means over them alone;
    ``fault`` "no_kl_grad" leaves the KL's gradient out of G's,
    "no_adv_grad" leaves out D(z)'s (their values stay in the loss), and
    "state_unchanged" counts each update and moves no parameter."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    check_supported(cfg)
    dev = images.device
    t, a, m = cfg["train"], cfg["adversarial"], cfg["model"]
    vae = models.build_vae(m, prec).to(dev)
    vae.load_state_dict(w_vae)
    d = models.build_latent_d(cfg, prec).to(dev)
    d.load_state_dict(w_d)
    g_names = [n for n, _ in vae.named_parameters()]
    d_names = [n for n, _ in d.named_parameters()]
    g_params = list(vae.parameters())
    d_params = list(d.parameters())
    for p in g_params + d_params:
        p.requires_grad_(True)
    updates = max(1, t["steps"])
    warm = max(1, min(t["lr_warmup_steps"], updates // 2))
    g_opt = Adam(g_params, warmup_cosine(0.0, t["lr"], warm,
                                         max(updates, warm + 1),
                                         t["lr_end_value"]),
                 t["grad_clip_norm"], b1=0.9, count=start)
    d_opt = Adam(d_params, lambda count: a["d_lr"], t["grad_clip_norm"],
                 b1=0.5, count=start)
    s = a["label_smoothing"]
    out = {"loss": [], "d_loss": [], "kl": [], "g_adv": [],
           "g_adv_scale": [], "grad": {}}
    for step in range(start, start + steps):
        gen = stream.step_generator(seed, step)
        x = images[torch.from_numpy(batch_rows(images.shape[0],
                                               t["batch_size"], seed,
                                               step)).to(dev)]
        u = torch.rand(x.shape, generator=stream.device_generator(gen, dev),
                       device=dev)
        x, u = x[:rows], u[:rows]
        x_in = (x.to(torch.float32) + u) / 256.0 * 2.0 - 1.0
        x_target = x.to(torch.float32) / 255.0
        beta = float(t["beta"])
        if t["beta_warmup_steps"] > 0:
            beta *= min(step / t["beta_warmup_steps"], 1.0)
        mean, logvar = vae.encode(x_in)
        key = stream.draw_key(gen)
        full = (t["batch_size"], mean.shape[1])
        eps = stream.normals(full[0] * full[1], *key, dev).reshape(
            full)[:mean.shape[0]]
        z = mean + torch.exp(0.5 * logvar) * eps
        kl = L.kl_standard(mean, logvar)
        recon = L.recon_ll(m["likelihood"], x_target, vae.decode(z))
        out["kl"].append(float(kl.detach().mean()))
        if fault == "no_kl_grad":
            kl = kl.detach()
        per_sample = recon
        if a["enabled"]:
            adv = d(z.detach() if fault == "no_adv_grad" else z)
            out["g_adv"].append(float(adv.detach().mean()))
            out["g_adv_scale"].append(float(adv.detach().std()))
            per_sample = per_sample + a["weight"] * beta * adv
        loss = -(per_sample.mean() - beta * kl.mean())
        grads = torch.autograd.grad(loss, g_params)
        move = fault != "state_unchanged"
        clipped = g_opt.step(list(grads), move)
        out["loss"].append(float(loss.detach()))
        if step == start:
            out["grad"].update({("vae", n): float(torch.linalg.vector_norm(g))
                                for n, g in zip(g_names, clipped)})
        if a["enabled"]:
            z_p = torch.randn(full, generator=stream.device_generator(
                gen, dev), device=dev)[:z.shape[0]]
            lq, lp = d(z.detach()), d(z_p)
            d_loss = (((1 - s) * F.softplus(-lq) + s * F.softplus(lq)).mean()
                      + ((1 - s) * F.softplus(lp)
                         + s * F.softplus(-lp)).mean())
            d_grads = torch.autograd.grad(d_loss, d_params)
            clipped = d_opt.step(list(d_grads), move)
            out["d_loss"].append(float(d_loss.detach()))
            if step == start:
                out["grad"].update(
                    {("d", n): float(torch.linalg.vector_norm(g))
                     for n, g in zip(d_names, clipped)})
    out["params"] = {**{("vae", n): p.detach() for n, p in
                        zip(g_names, g_params)},
                     **{("d", n): p.detach() for n, p in
                        zip(d_names, d_params)}}
    return out
